"""Port parity, the sharded demod: psk_soft_tpu_torch/parallel/sharded.
make_sharded_demod on a mesh of CPU shards against the JAX package's
make_sharded_demod on its 8 virtual CPU devices (tests/conftest.py), fed
the same numpy samples (tests/test_sharding.py's cases).

Tolerances: valid masks, bits and sample index equal; soft within 1e-5
of JAX's, phase within 1e-5 plus 1e-6 of its value (the unwrapped phase
grows to ~60 rad here, where 1e-5 is 3 float32 steps and the two FIR
sums add in different orders).  Within the port, the sharded result
equals its own single-device feed-forward run as tests/test_sharding.py
holds JAX's (bits and sample index equal, soft and phase within 1e-4).
Signals carry frequency offset and noise on timing-decisive pulses, so
the timing argmax has structure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.parallel.mesh import chan_time_sharding as jax_sharding
from psk_soft_tpu.parallel.mesh import make_mesh as jax_make_mesh
from psk_soft_tpu.parallel.sharded import \
    make_sharded_demod as jax_make_sharded_demod
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu_torch.parallel.mesh import make_mesh
from psk_soft_tpu_torch.parallel.sharded import make_sharded_demod

torch.set_num_threads(1)

C, NS = 8, 1600
JAX_TOL, PHASE_RTOL, FF_TOL = 1e-5, 1e-6, 1e-4


def _signals(cfg, m=4):
    """tests/test_sharding.py's timing-decisive channels."""
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, m, NS)
        pts = np.exp(2j * np.pi * j / m)
        if cfg.differential:
            pts = np.cumprod(pts)
        x = np.zeros(NS * cfg.sps, np.complex64)
        t = np.arange(NS)
        x[3::cfg.sps] = pts * np.exp(2j * np.pi * 2e-4 * cfg.sps * t)
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _np(out):
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _check(cfg, chan, time):
    xs = _signals(cfg, m=cfg.constellation_size)
    got = _np(make_sharded_demod(cfg, make_mesh(chan, time, ["cpu"] * 8),
                                 NS)(torch.from_numpy(xs)))
    jcfg = JaxDemodConfig(**cfg.__dict__)
    jmesh = jax_make_mesh(chan=chan, time=time)
    ref = _np(jax_make_sharded_demod(jcfg, jmesh, NS)(
        jax.device_put(jnp.asarray(xs), jax_sharding(jmesh))))
    for k in ("valid", "bits", "sample_index"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["soft"], ref["soft"], rtol=0,
                               atol=JAX_TOL)
    np.testing.assert_allclose(got["phase"], ref["phase"], rtol=PHASE_RTOL,
                               atol=JAX_TOL)
    # The port's own single-device feed-forward run.
    _, ff = make_ff_demod_fn(cfg, channels=C)(ff_init(cfg, C, "cpu"),
                                              torch.from_numpy(xs))
    ff = _np(ff)
    v1, v2 = ff["valid"], got["valid"]
    assert v1.sum() == v2.sum() == C * (NS - cfg.num_avg + 1)
    for k in ("bits", "sample_index"):
        np.testing.assert_array_equal(got[k][v2], ff[k][v1], err_msg=k)
    for k in ("soft", "phase"):
        np.testing.assert_allclose(got[k][v2], ff[k][v1], rtol=0,
                                   atol=FF_TOL, err_msg=k)


@pytest.mark.parametrize("chan,time", [(8, 1), (1, 8), (2, 4), (4, 2)])
def test_sharded_matches_jax_and_single_device(chan, time):
    _check(DemodConfig(sps=8, num_avg=100, constellation_size=4,
                       phase_avg=50), chan, time)


@pytest.mark.parametrize("m,diff", [(2, False), (8, False), (4, True)])
def test_sharded_modes_match_jax(m, diff):
    _check(DemodConfig(sps=8, num_avg=50, constellation_size=m, phase_avg=20,
                       differential=diff), 2, 4)


def test_shard_size_guard():
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
    mesh = make_mesh(chan=1, time=8, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="symbols per time shard"):
        make_sharded_demod(cfg, mesh, 400)  # 50/shard < num_avg-1
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_demod(cfg, mesh, 1604)
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh(chan=3, time=3, devices=["cpu"] * 8)
