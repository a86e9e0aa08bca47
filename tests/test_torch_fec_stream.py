"""Port parity, streaming and time-parallel Viterbi: psk_soft_tpu_torch's
ops/fec stream step, flush, time-parallel decode and stream soft step
against the JAX package on the CPU, fed the same numpy inputs.

Tolerances: bits and decision windows equal; path metrics within 1e-4
(float32 sums in another order).  The JAX decoders run as the JAX
package's own tests run them: the XLA scan (``backend="xla"``) and, for
one case, the Pallas kernels in interpret mode (``backend="pallas"``, as
tests/test_viterbi_kernel.py runs them).  The kernel route of the stream
step (B3 + B4 on a CUDA tensor) is also driven here on CPU tensors, where
its wrappers run the kernels' plain versions: the layouts around the
kernels (transposes, the [history | new] plane, the window kept) are held
to the plain path.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.utils import checkpoint as jckpt
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import fec
from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk
from psk_soft_tpu_torch.utils import checkpoint, interop

torch.set_num_threads(1)

PM_TOL = 1e-4

CODES = {
    "k3": (jfec.CODE_K3, fec.CODE_K3, 16),
    "k7": (jfec.CODE_K7, fec.CODE_K7, 40),
    "k9": (jfec.CODE_K9, fec.CODE_K9, 50),
    "k7p23": (jfec.ConvCode(7, (0o171, 0o133), jfec.PUNCTURE_2_3),
              fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_2_3), 48),
}


def _steps(code, rows: int, n_info: int, sigma: float, seed: int):
    """Noisy depunctured (rows, T, n) LLR steps of random bits, with the
    bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (rows, n_info)).astype(np.int8)
    coded = fec.conv_encode(code, bits, terminate=False).numpy()
    llr = ((1.0 - 2.0 * coded)
           + sigma * rng.standard_normal(coded.shape)).astype(np.float32)
    full = fec.depuncture(code, torch.from_numpy(llr)).numpy()
    return full.reshape(rows, -1, code.n), bits, llr


def _same_state(st, jst):
    np.testing.assert_array_equal(st.dec.numpy(), np.asarray(jst.dec))
    np.testing.assert_allclose(st.pm.numpy(), np.asarray(jst.pm),
                               atol=PM_TOL, rtol=0)


@pytest.mark.parametrize("known_start", [True, False])
@pytest.mark.parametrize("name", sorted(CODES))
def test_stream_step_matches_jax_xla(name, known_start):
    """Block by block: emitted bits and the decision window equal, the
    metrics within 1e-4; the flush equal."""
    jcode, code, depth = CODES[name]
    steps, _, _ = _steps(code, 3, 160, 0.7, seed=len(name))
    jst = jfec.viterbi_stream_init(jcode, 3, depth, known_start=known_start)
    st = fec.viterbi_stream_init(code, 3, depth, known_start=known_start,
                                 device="cpu")
    _same_state(st, jst)
    for lo in range(0, steps.shape[1], 50):
        blk = steps[:, lo:lo + 50]
        jst, jb = jfec.viterbi_stream_step(jcode, jst, blk, backend="xla")
        st, b = fec.viterbi_stream_step(code, st, torch.from_numpy(blk))
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        _same_state(st, jst)
    np.testing.assert_array_equal(
        fec.viterbi_stream_flush(code, st).numpy(),
        np.asarray(jfec.viterbi_stream_flush(jcode, jst)))


def test_stream_step_matches_pallas_interpret():
    """One case against the Pallas stream block in interpret mode."""
    jcode, code, depth = CODES["k7"]
    steps, _, _ = _steps(code, 2, 64, 0.5, seed=5)
    jst = jfec.viterbi_stream_init(jcode, 2, depth)
    st = fec.viterbi_stream_init(code, 2, depth, device="cpu")
    for lo in (0, 32):
        blk = steps[:, lo:lo + 32]
        jst, jb = jfec.viterbi_stream_step(jcode, jst, blk, backend="pallas")
        st, b = fec.viterbi_stream_step(code, st, torch.from_numpy(blk))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        _same_state(st, jst)


@pytest.mark.parametrize("poison", [False, True])
def test_kernel_route_layout_on_plain_versions(poison):
    """The stream step's and flush's kernel route (B3 then B4 over the
    [history | new] plane; B4 over the window), run with the wrappers'
    plain versions, equals the plain path: bits, window and metrics equal,
    also from NaN-poisoned metrics (the start takes the first NaN, as
    torch.argmax does) and from uniform ones."""
    code = fec.CODE_K7
    steps, _, _ = _steps(code, 5, 90, 0.8, seed=17)
    st = fec.viterbi_stream_init(code, 5, 42, known_start=False,
                                 device="cpu")
    if poison:
        pm = st.pm.clone()
        pm[1, 9] = float("nan")
        pm[3] = float("nan")
        st = st._replace(pm=pm)
    ref = st
    for lo in (0, 45):
        blk = torch.from_numpy(steps[:, lo:lo + 45])
        ref, want = fec.viterbi_stream_step(code, ref, blk)
        st, got = fec._stream_block_kernels(code, st, blk)
        assert torch.equal(got, want) and torch.equal(st.dec, ref.dec)
        assert st.dec.dtype == torch.bool and st.dec.is_contiguous()
        assert torch.equal(st.pm.isnan(), ref.pm.isnan())
        keep = ~ref.pm.isnan()
        assert torch.equal(st.pm[keep], ref.pm[keep])
    assert torch.equal(fec._stream_tail_kernel(code, st),
                       fec.viterbi_stream_flush(code, ref))
    assert (vk.viterbi_acs.launches, vk.viterbi_traceback.launches) == (0, 0)


def _run_stream(code, steps, depth: int, chunks) -> np.ndarray:
    st = fec.viterbi_stream_init(code, steps.shape[0], depth, device="cpu")
    out, lo = [], 0
    for c in chunks:
        st, b = fec.viterbi_stream_step(code, st,
                                        torch.from_numpy(steps[:, lo:lo + c]))
        out.append(b.numpy())
        lo += c
    st, b = fec.viterbi_stream_step(code, st, torch.from_numpy(steps[:, lo:]))
    out.append(b.numpy())
    out.append(fec.viterbi_stream_flush(code, st).numpy())
    return np.concatenate(out, axis=1)[:, depth:]


def test_stream_split_invariance_and_one_shot():
    """Any block split (an empty last block included) gives the same bits,
    equal after the D-step lag to one unterminated decode of the whole
    stream, which decodes the sent bits at this noise."""
    code, depth = fec.CODE_K7, 70
    steps, bits, llr = _steps(code, 2, 300, 0.45, seed=92)
    a = _run_stream(code, steps, depth, [300])
    for chunks in ([100, 150], [1, 1, 298], [133]):
        np.testing.assert_array_equal(_run_stream(code, steps, depth, chunks),
                                      a)
    full = fec.viterbi_decode(code, torch.from_numpy(llr), terminate=False)
    np.testing.assert_array_equal(a, full.numpy())
    np.testing.assert_array_equal(a, bits)


@pytest.mark.parametrize("name", ["k3", "k7p23"])
def test_decode_parallel_matches_jax_and_sequential(name):
    """Overlapping windows equal JAX's time-parallel decode and the
    port's sequential decode; a stream no longer than one window defers to
    the sequential decode."""
    jcode, code, _ = CODES[name]
    _, _, llr = _steps(code, 2, 420, 0.5, seed=41)
    margin = 5 * code.k
    got = fec.viterbi_decode_parallel(code, torch.from_numpy(llr), chunk=64,
                                      margin=margin)
    want = jfec.viterbi_decode_parallel(jcode, llr, chunk=64, margin=margin,
                                        backend="xla")
    seq = fec.viterbi_decode(code, torch.from_numpy(llr), terminate=False)
    assert got.shape == (2, 420) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), seq.numpy())
    short = torch.from_numpy(llr[:, :llr.shape[1] // 6])
    np.testing.assert_array_equal(
        fec.viterbi_decode_parallel(code, short, chunk=64,
                                    margin=margin).numpy(),
        fec.viterbi_decode(code, short, terminate=False).numpy())
    with pytest.raises(ValueError, match="margin"):
        fec.viterbi_decode_parallel(code, short, margin=code.k - 1)


@pytest.mark.parametrize("labeling", ["scd", "gray"])
def test_make_stream_soft_fn_matches_jax(labeling):
    """LLRs, depuncturing and the stream step from QPSK soft symbols."""
    rng = np.random.default_rng(3)
    for jcode, code, depth in (CODES["k7"], CODES["k7p23"]):
        soft = (rng.standard_normal((2, 96))
                + 1j * rng.standard_normal((2, 96))).astype(np.complex64)
        jst = jfec.viterbi_stream_init(jcode, 2, depth)
        st = fec.viterbi_stream_init(code, 2, depth, device="cpu")
        jfn = jfec.make_stream_soft_fn(jcode, 4, labeling, backend="xla")
        fn = fec.make_stream_soft_fn(code, 4, labeling)
        for half in (soft[:, :48], soft[:, 48:]):
            jst, jb = jfn(jst, jnp.asarray(half))
            st, b = fn(st, torch.from_numpy(half))
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
            _same_state(st, jst)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_state_checkpoints_cross(direction, tmp_path):
    """A ViterbiStreamState saved mid-stream by one package loads in the
    other (the .npz format and the interop dicts), and the continuation's
    bits equal the uninterrupted run's."""
    jcode, code, depth = CODES["k7"]
    steps, _, _ = _steps(code, 2, 120, 0.6, seed=8)
    jst = jfec.viterbi_stream_init(jcode, 2, depth)
    jst, _ = jfec.viterbi_stream_step(jcode, jst, steps[:, :60],
                                      backend="xla")
    st = fec.viterbi_stream_init(code, 2, depth, device="cpu")
    st, _ = fec.viterbi_stream_step(code, st, torch.from_numpy(steps[:, :60]))
    path = os.path.join(tmp_path, "vs.npz")
    kw = dict(sps=8, num_avg=40, constellation_size=4, phase_avg=30)
    if direction == "jax_to_port":
        jckpt.save_state(path, jst, JaxDemodConfig(**kw))
        loaded, _, _ = checkpoint.load_state(path, "cpu")
        via = interop.viterbi_stream_state_from_numpy(
            {f: np.asarray(getattr(jst, f)) for f in jst._fields}, "cpu")
        for f in st._fields:
            assert torch.equal(getattr(via, f), getattr(loaded, f))
        _same_state(loaded, jst)
        _, got = fec.viterbi_stream_step(code, loaded,
                                         torch.from_numpy(steps[:, 60:]))
    else:
        checkpoint.save_state(path, st, DemodConfig(**kw))
        loaded, _, _ = jckpt.load_state(path)
        arrays = interop.viterbi_stream_state_to_numpy(st)
        assert arrays["dec"].dtype == np.bool_
        np.testing.assert_array_equal(arrays["dec"], np.asarray(loaded.dec))
        _same_state(st, loaded)
        _, got = jfec.viterbi_stream_step(jcode, loaded, steps[:, 60:],
                                          backend="xla")
        got = torch.from_numpy(np.array(got))
    _, want = fec.viterbi_stream_step(code, st,
                                      torch.from_numpy(steps[:, 60:]))
    assert torch.equal(got, want)


def test_stream_validation():
    code = fec.CODE_K7
    with pytest.raises(ValueError, match="depth"):
        fec.viterbi_stream_init(code, 1, 3, device="cpu")
    st = fec.viterbi_stream_init(code, 2, 40, device="cpu")
    with pytest.raises(ValueError, match="LLR steps"):
        fec.viterbi_stream_step(code, st, torch.zeros(2, 10, 3))
    st2, b = fec.viterbi_stream_step(code, st, torch.zeros(2, 0, 2))
    assert st2 is st and b.shape == (2, 0) and b.dtype == torch.int8
