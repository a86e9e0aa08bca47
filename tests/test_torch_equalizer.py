"""Port parity, the equalizer: psk_soft_tpu_torch's ops/equalizer
(EqConfig, eq_init, eq_block, make_eq_fn, multipath) and
runtime/equalizer.EqFrontEnd against the JAX package on the CPU, fed the
same numpy blocks.

Tolerances: equalized samples within 1e-5 (tests/test_equalizer.py's
streaming bound; 1e-6 for frozen DD as there); the weights within 1e-5
after every update of a 60-block adaptation (the per-block gradient sums
in another order than JAX's einsum, so one block's rounding is not the
bound); cm_err and grad_norm within rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import equalizer as je
from psk_soft_tpu.runtime.engine import BatchEngine as JaxBatchEngine
from psk_soft_tpu.runtime.equalizer import EqFrontEnd as JaxEqFrontEnd
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import equalizer as te
from psk_soft_tpu_torch.runtime.engine_batch import BatchEngine
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.equalizer import EqFrontEnd
from psk_soft_tpu_torch.runtime.quality import QualityMonitor

torch.set_num_threads(1)

TOL = 1e-5
CHAN = [1.0, 0.0, 0.45 * np.exp(1j * 2.1), 0.2 * np.exp(-1j * 0.7)]


def _qpsk(c, syms, sps, seed=0, snr_db=30.0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4, (c, syms))
    x = np.repeat(np.exp(2j * np.pi * idx / 4), sps, axis=1)
    sigma = 10.0 ** (-snr_db / 20.0)
    x = x + sigma / np.sqrt(2) * (rng.standard_normal(x.shape)
                                  + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64), idx


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_identity_passthrough_multipath_and_validation():
    """Identity init delays the input by the centre tap (grad norm 0 at
    mu 0), as in JAX; multipath equals JAX's helper; EqConfig and eq_block
    refuse what JAX refuses."""
    cfg = te.EqConfig(taps=9, mu=0.0)
    x, _ = _qpsk(3, 64, 4, seed=1)
    st, y, info = te.eq_block(cfg, te.eq_init(cfg, (3,), "cpu"), _t(x))
    d = cfg.center_tap
    np.testing.assert_allclose(y.numpy()[:, d:], x[:, :x.shape[1] - d],
                               atol=1e-6)
    assert float(info["grad_norm"].max()) == 0.0
    assert st.w.dtype == st.hist.dtype == torch.complex64
    assert tuple(te.eq_init(cfg, 5, "cpu").hist.shape) == (5, 8)
    np.testing.assert_array_equal(te.multipath(x, CHAN),
                                  je.multipath(x, CHAN))
    for bad in (dict(taps=0), dict(stride=0), dict(taps=5, center=5),
                dict(mu=-1.0), dict(leak=-1.0), dict(mode="rls"),
                dict(mode="dd", dd_m=3), dict(dd_gate=-0.1)):
        with pytest.raises(ValueError):
            je.EqConfig(**bad)
        with pytest.raises(ValueError):
            te.EqConfig(**bad)
    cfg = te.EqConfig(taps=9, stride=4)
    with pytest.raises(ValueError, match="stride"):
        te.eq_block(cfg, te.eq_init(cfg, (1,), "cpu"),
                    torch.zeros((1, 30), dtype=torch.complex64))
    cfg = te.EqConfig(taps=9)
    with pytest.raises(ValueError, match="taps-1"):
        te.eq_block(cfg, te.eq_init(cfg, (1,), "cpu"),
                    torch.zeros((1, 4), dtype=torch.complex64))


@pytest.mark.parametrize("mode", ["cma", "dd"])
def test_frozen_streaming_equals_oneshot_any_split(mode):
    """Frozen weights: streaming over any split equals one-shot filtering
    and the JAX one-shot output (the history carry)."""
    kw = dict(taps=11, mu=0.0, mode=mode)
    rng = np.random.default_rng(2)
    w = ((rng.standard_normal((2, 11)) + 1j * rng.standard_normal((2, 11)))
         * 0.3).astype(np.complex64)
    x, _ = _qpsk(2, 200, 4, seed=3)
    _, jy, _ = je.make_eq_fn(je.EqConfig(**kw))(
        je.eq_init(je.EqConfig(**kw), (2,))._replace(w=w), x)
    cfg = te.EqConfig(**kw)
    fn = te.make_eq_fn(cfg)
    _, y_once, _ = fn(te.eq_init(cfg, (2,), "cpu")._replace(w=_t(w)), _t(x))
    np.testing.assert_allclose(y_once.numpy(), np.asarray(jy), atol=TOL)
    for splits in ([100], [17, 200, 555], list(range(40, 800, 40))):
        st = te.eq_init(cfg, (2,), "cpu")._replace(w=_t(w))
        outs = []
        for blk in np.split(x, splits, axis=1):
            st, y, info = fn(st, _t(blk))
            outs.append(y.numpy())
        np.testing.assert_allclose(np.concatenate(outs, axis=1),
                                   y_once.numpy(),
                                   atol=1e-6 if mode == "dd" else TOL)
        assert torch.equal(st.w, _t(w)) and not info["grad_norm"].any()


@pytest.mark.parametrize("case", ["cma", "dd", "stride_leak", "dd_nogate",
                                  "freeze"])
def test_adaptation_matches_jax(case):
    """60 block updates of 400 samples over tests/test_equalizer.py's
    multipath channel (rotated): weights, outputs, cm_err and grad_norm
    against JAX after every block; CMA inverts the channel (cost down
    15x)."""
    kw = {"cma": dict(taps=15, mu=5e-4),
          "dd": dict(taps=9, mu=3e-4, mode="dd"),
          "stride_leak": dict(taps=15, mu=5e-4, stride=4, leak=1e-3),
          "dd_nogate": dict(taps=9, mu=1e-4, mode="dd", dd_m=8,
                            dd_gate=0.0),
          "freeze": dict(taps=15, mu=5e-4, freeze=True)}[case]
    x, _ = _qpsk(4, 6000, 4, seed=4)
    rx = (je.multipath(x, CHAN) * np.exp(1j * 0.77)).astype(np.complex64)
    jcfg, cfg = je.EqConfig(**kw), te.EqConfig(**kw)
    jst, st = je.eq_init(jcfg, (4,)), te.eq_init(cfg, (4,), "cpu")
    jfn, fn = je.make_eq_fn(jcfg), te.make_eq_fn(cfg)
    errs = []
    for blk in np.split(rx[:, :24000], 60, axis=1):
        jst, jy, ji = jfn(jst, blk)
        st, y, info = fn(st, _t(blk))
        np.testing.assert_allclose(st.w.numpy(), np.asarray(jst.w),
                                   atol=TOL)
        np.testing.assert_allclose(st.hist.numpy(), np.asarray(jst.hist),
                                   atol=0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
        for k in ("cm_err", "grad_norm"):
            np.testing.assert_allclose(info[k].numpy(), np.asarray(ji[k]),
                                       rtol=1e-4, atol=1e-9, err_msg=k)
        errs.append(float(info["cm_err"][0]))
    if case == "cma":
        assert errs[-1] < errs[0] / 15.0, (errs[0], errs[-1])


def test_front_end_surface_matches_jax():
    """tests/test_equalizer.py's surface test driven into both front ends
    side by side: ragged pushes staged to the lockstep grid, the same
    weights as one push_block, ragged-pending refusal, reset_eq, freeze,
    adapt, planes; reset keeps the weights and drops the history."""
    kw = dict(sps=4, num_avg=20, constellation_size=4, phase_avg=10)
    x, _ = _qpsk(2, 64, 4, seed=7)
    jfe = JaxEqFrontEnd(JaxBatchEngine(JaxDemodConfig(**kw), 2,
                                       block_symbols=32))
    fe = EqFrontEnd(BatchEngine(DemodConfig(**kw), 2, block_symbols=32,
                                device="cpu"))
    for f in (jfe, fe):
        f.push(0, x[0])
        assert f.updates == 0
        f.push(1, x[1])
        assert f.updates == 1
    np.testing.assert_allclose(fe.weights, jfe.weights, atol=TOL)
    fe2 = EqFrontEnd(BatchEngine(DemodConfig(**kw), 2, block_symbols=32,
                                 device="cpu"))
    fe2.push_block(x)
    np.testing.assert_array_equal(fe.weights, fe2.weights)
    fe.push(0, x[0][:3])
    with pytest.raises(ValueError, match="ragged"):
        fe.push_block(x)
    with pytest.raises(ValueError, match="ragged"):
        fe.push_planes(np.ascontiguousarray(x.real.T),
                       np.ascontiguousarray(x.imag.T))
    for f in (jfe, fe):
        f.reset_eq()
        f.push_block(x)
        assert f.updates == 1
        f.freeze()
        f.push_block(x)
        assert f.updates == 1
        w0 = f.weights.copy()
        f.push_block(x)
        np.testing.assert_array_equal(f.weights, w0)
        f.adapt()
        f.push_block(x)
        assert f.updates == 2 and f.cm_err.shape == (2,)
        f.push_planes(np.ascontiguousarray(x.real.T),
                      np.ascontiguousarray(x.imag.T))
    np.testing.assert_allclose(fe.weights, jfe.weights, atol=TOL)
    np.testing.assert_allclose(fe.cm_err, jfe.cm_err, rtol=1e-4)
    assert fe.cm_err.dtype == np.float32
    w = fe.weights.copy()
    fe.reset()
    np.testing.assert_array_equal(fe.weights, w)
    assert not fe._state.hist.abs().any()
    fe.reset_eq()
    assert fe.updates == 0 and not fe.cm_err.any()


def test_front_end_auto_switch_and_reset_matches_jax():
    """The CMA -> DD handover on the worst channel's cost after dd_hold
    updates, at the same update as JAX's, and reset_eq back to CMA."""
    kw = dict(sps=4, num_avg=20, constellation_size=4, phase_avg=10)
    x, _ = _qpsk(2, 4096, 4, seed=11)
    rx = je.multipath(x, [1.0, 0.0, 0.3j])
    jfe = JaxEqFrontEnd(JaxBatchEngine(JaxDemodConfig(**kw), 2,
                                       block_symbols=64),
                        je.EqConfig(taps=15, mu=5e-4), dd_switch=0.05,
                        dd_hold=2)
    fe = EqFrontEnd(BatchEngine(DemodConfig(**kw), 2, block_symbols=64,
                                device="cpu"),
                    te.EqConfig(taps=15, mu=5e-4), dd_switch=0.05,
                    dd_hold=2)
    modes = []
    for pos in range(0, rx.shape[1] - 511, 512):
        jfe.push_block(rx[:, pos:pos + 512])
        fe.push_block(_t(rx[:, pos:pos + 512]))
        modes.append((fe.mode, jfe.mode))
        np.testing.assert_allclose(fe.weights, jfe.weights, atol=TOL)
    assert all(a == b for a, b in modes) and fe.mode == "dd"
    assert fe.cm_err.mean() < 0.05
    fe.reset_eq()
    assert fe.mode == "cma"


def test_front_end_restores_demod_through_live_engine():
    """tests/test_equalizer.py's live test on the port: a one-symbol echo
    wrecks the un-equalized constellation; EqFrontEnd (33 taps, mu 5e-5)
    restores it (EVM halved, lock > 0.8, SNR up 6 dB), and its weights
    equal the JAX front end's on the same blocks."""
    sps = 8
    kw = dict(sps=sps, num_avg=50, constellation_size=4, phase_avg=50)
    chan = [1.0] + [0.0] * 7 + [0.5j]
    x, _ = _qpsk(2, 8192, sps, seed=6, snr_db=35.0)
    rx = te.multipath(x, chan)
    blocks = np.split(rx, rx.shape[1] // (256 * sps), axis=1)

    def run(equalized):
        eng = QualityMonitor(BatchEngine(DemodConfig(**kw), 2,
                                         block_symbols=256, device="cpu"),
                             alpha=0.05)
        fe = EqFrontEnd(eng, te.EqConfig(taps=33, mu=5e-5)) \
            if equalized else eng
        for blk in blocks:
            fe.push_block(blk)
            fe.step_packets()
        return eng.snapshot(), fe

    raw, _ = run(False)
    eq, fe = run(True)
    assert (eq["evm_pct"] < raw["evm_pct"] / 2).all(), (raw, eq)
    assert (eq["lock"] > 0.8).all()
    assert (eq["snr_db"] > raw["snr_db"] + 6).all()
    jfe = JaxEqFrontEnd(JaxBatchEngine(JaxDemodConfig(**kw), 2,
                                       block_symbols=256),
                        je.EqConfig(taps=33, mu=5e-5))
    for blk in blocks:
        jfe.push_block(blk)
    np.testing.assert_allclose(fe.weights, jfe.weights, atol=TOL)


def test_front_end_planes_stay_tensors_and_refuse_int16():
    """push_planes hands the wrapped engine tensors on its device (the
    equalized planes equal push_block's), and refuses int16 planes and an
    inner engine with ingest_scale."""
    cfg = DemodConfig(sps=4, num_avg=20, constellation_size=4, phase_avg=10)
    x, _ = _qpsk(128, 64, 4, seed=2)
    a = EqFrontEnd(FullKernelBatchEngine(cfg, 128, block_symbols=64,
                                         device="cpu"),
                   te.EqConfig(taps=9, mu=1e-4))
    b = EqFrontEnd(FullKernelBatchEngine(cfg, 128, block_symbols=64,
                                         device="cpu"),
                   te.EqConfig(taps=9, mu=1e-4))
    a.push_planes(_t(x.real.T), _t(x.imag.T))
    b.push_block(x)
    assert isinstance(a.engine._plane_re[0], torch.Tensor)
    got = torch.complex(a.engine._plane_re[0], a.engine._plane_im[0]).T
    want = np.stack(b.engine._staging)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-9)
    with pytest.raises(ValueError, match="int16"):
        a.push_planes(torch.zeros((64, 128), dtype=torch.int16),
                      torch.zeros((64, 128), dtype=torch.int16))
    wire = EqFrontEnd(FullKernelBatchEngine(cfg, 128, block_symbols=64,
                                            ingest_scale=1e-3,
                                            device="cpu"))
    with pytest.raises(ValueError, match="int16"):
        wire.push_planes(np.zeros((64, 128), np.float32),
                         np.zeros((64, 128), np.float32))
