"""Port parity, FEC under the mesh: the bit layer shard_mapped over the
`chan` axis of a mesh of CPU shards (no collectives) against the JAX
package's single-device decode on the same numpy LLRs
(tests/test_fec_sharded.py's cases).

Bits equal the JAX decode and the transmitted bits; the streaming block's
delayed bits equal JAX's; the sharded LLRs within 1e-5 of JAX's
(tests/test_fec_sharded.py:105).  The ACS normalization is per row, so
sharding the batch cannot change a result: the port's sharded output also
equals its own single-shard run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.ops import tx as jtx
from psk_soft_tpu_torch.ops.fec import (CODE_K7, ViterbiStreamState,
                                        make_stream_soft_fn, psk_llrs,
                                        viterbi_decode, viterbi_stream_init)
from psk_soft_tpu_torch.parallel.mesh import P, make_mesh, shard_map

torch.set_num_threads(1)


def _mesh(chan):
    return make_mesh(chan=chan, devices=["cpu"] * 8)


@pytest.mark.parametrize("chan_shards", [2, 4, 8])
def test_channel_sharded_viterbi_matches_single(chan_shards):
    rng = np.random.default_rng(141)
    C, n_bits = 8, 400
    bits = rng.integers(0, 2, (C, n_bits), np.int8)
    coded = np.asarray(jfec.conv_encode(jfec.CODE_K7, bits))
    llrs = ((1.0 - 2.0 * coded)
            + 0.4 * rng.standard_normal(coded.shape)).astype(np.float32)
    single = np.asarray(jfec.viterbi_decode(jfec.CODE_K7, llrs))
    got = shard_map(lambda rows: viterbi_decode(CODE_K7, rows),
                    _mesh(chan_shards), in_specs=P("chan", None),
                    out_specs=P("chan", None),
                    collectives=False)(torch.from_numpy(llrs)).numpy()
    assert np.array_equal(got, single)
    assert np.array_equal(got, bits)


def test_channel_sharded_stream_block_matches_single():
    rng = np.random.default_rng(142)
    C, n_sym = 8, 768
    bits = rng.integers(0, 2, (C, n_sym), np.int8)
    coded = np.asarray(jfec.conv_encode(jfec.CODE_K7, bits, terminate=False))
    syms = jtx.symbols_to_iq(
        4, jtx.bits_to_symbols(4, coded.reshape(-1)).reshape(C, -1))
    noisy = (np.asarray(syms) + 0.1 * (rng.standard_normal(syms.shape)
                                       + 1j * rng.standard_normal(syms.shape))
             ).astype(np.complex64)
    jst = jfec.viterbi_stream_init(jfec.CODE_K7, C, 70)
    _, ref_bits = jfec.make_stream_soft_fn(jfec.CODE_K7, 4)(
        jst, jnp.asarray(noisy))

    fn = make_stream_soft_fn(CODE_K7, 4)
    st = viterbi_stream_init(CODE_K7, C, 70, device="cpu")

    def per_shard(pm_s, dec_s, soft_s):
        st2, b = fn(ViterbiStreamState(pm=pm_s, dec=dec_s), soft_s)
        return st2.pm, st2.dec, b

    specs = (P("chan", None), P(None, "chan", None), P("chan", None))
    pm2, dec2, got = shard_map(per_shard, _mesh(4), in_specs=specs,
                               out_specs=specs, collectives=False)(
        st.pm, st.dec, torch.from_numpy(noisy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_bits))
    st1, single = fn(st, torch.from_numpy(noisy))
    assert torch.equal(got, single) and torch.equal(dec2, st1.dec)
    assert torch.equal(pm2, st1.pm)


def test_sharded_llr_kernel_matches_single():
    rng = np.random.default_rng(143)
    soft = (rng.standard_normal((8, 256))
            + 1j * rng.standard_normal((8, 256))).astype(np.complex64)
    single = np.asarray(jfec.psk_llrs(8, soft))
    got = shard_map(lambda rows: psk_llrs(8, rows), _mesh(8),
                    in_specs=P("chan", None), out_specs=P("chan", None, None),
                    collectives=False)(torch.from_numpy(soft))
    np.testing.assert_allclose(got.numpy(), single, rtol=0, atol=1e-5)
    assert torch.equal(got, psk_llrs(8, torch.from_numpy(soft)))
