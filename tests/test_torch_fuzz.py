"""Port parity, the JAX package's randomized demod suites: the cases of
tests/test_fuzz_full_kernel.py, tests/test_fuzz_output_formats.py,
tests/test_fuzz_equiv.py and tests/test_tiebreak.py, drawn from the port's
own copies of their generators (psk_soft_tpu_torch/testing/conformance).

* The case lists equal the JAX modules' ``CASES``.
* Full-kernel and format cases: kernel B1's plain version
  (``models/full.demod_block_full`` on CPU tensors) from the port's
  feed-forward warm-up, held to the JAX tests' invariants (sample index
  equal to the feed-forward run's, soft within 5e-3; the format options
  against the option-free run), and the port's feed-forward run equal to
  the JAX one on the same numpy input under tests/test_full_kernel.py:
  60-68's bounds (bits and sample index equal, soft 3e-3, phase 2e-3).
* Equivalence cases: the exact scan and the feed-forward pipeline over
  ragged blocks equal to each other (valid and bits equal, soft 5e-3) and
  each to its JAX counterpart (valid, bits and sample index equal, soft
  and phase within 2e-3, the exact path's parity bounds).
* Ties: the first maximum (sample index 0) on the exact-tie signal through
  the exact scan, the feed-forward pipeline and B1, as the JAX package's.
* The feed-forward carry's resync on a phase_avg change against the JAX
  test's loop oracle.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psk_soft_tpu as jpst
from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models import blockpsk as jblockpsk
from psk_soft_tpu.utils.transfer import to_host
import psk_soft_tpu_torch as pst
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import blockpsk, full
from psk_soft_tpu_torch.testing import conformance as cf

torch.set_num_threads(1)

C = cf.FUZZ_C
FUZZ_SOFT_TOL = 5e-3          # kernel vs feed-forward (the fuzz tests')
SOFT_TOL, PHASE_TOL = 3e-3, 2e-3   # tests/test_full_kernel.py:60-68
EXACT_TOL = 2e-3              # tests/test_oracle_parity.py:45-47
TESTS = Path(__file__).resolve().parent


def _jax_module(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,ours", [
    ("test_fuzz_full_kernel", cf.FULL_KERNEL_CASES),
    ("test_fuzz_output_formats", cf.FORMAT_CASES),
    ("test_fuzz_equiv", cf.EQUIV_CASES)])
def test_case_lists_equal_jax(name, ours):
    assert ours == _jax_module(name).CASES


def _planes(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real.T)),
            torch.from_numpy(np.ascontiguousarray(x.imag.T)))


def _wrapped(a, b, period):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d - period * np.round(d / period)).max()


def _ff_runs(kw, warm, run):
    """The port's and the JAX feed-forward bank over warm then run:
    (port carry after warm, port run outputs, JAX run outputs)."""
    cfg, jcfg = DemodConfig(**kw), JaxDemodConfig(**kw)
    fn = blockpsk.make_ff_demod_fn(cfg, channels=C)
    st, _ = fn(blockpsk.ff_init(cfg, C, "cpu"), torch.from_numpy(warm))
    _, out = fn(st, torch.from_numpy(run))
    jfn = jblockpsk.make_ff_demod_fn(jcfg, channels=C)
    jst, _ = jfn(jblockpsk.ff_init(jcfg, (C,)), jnp.asarray(warm))
    _, jout = jfn(jst, jnp.asarray(run))
    return st, out, to_host(jout)


def _assert_ff_matches_jax(out, jout, m):
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    np.testing.assert_array_equal(out.sample_index.numpy(),
                                  np.asarray(jout.sample_index))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    np.testing.assert_allclose(out.soft.numpy(), np.asarray(jout.soft),
                               atol=SOFT_TOL)
    assert _wrapped(out.phase.numpy(), jout.phase, 2 * np.pi * m) < PHASE_TOL


def _b1_setup(case):
    """A B1 case's config, carry (from the port's warm-up), run block and
    feed-forward outputs, with the ff run held against JAX's."""
    cfg = DemodConfig(**case["cfg"])
    xs = cf.fuzz_signal(cfg, case["warm"] + case["run"])
    warm, run = np.split(xs, [case["warm"] * cfg.sps], axis=1)
    st_ff, out_ff, jout_ff = _ff_runs(case["cfg"], warm, run)
    _assert_ff_matches_jax(out_ff, jout_ff, cfg.constellation_size)
    keep = full.window_rows(cfg)
    raw_win = (torch.from_numpy(warm[:, warm.shape[1] - keep:])
               if cfg.matched_filter != "none" else None)
    st = full.full_from_ff(cfg, st_ff, raw_win=raw_win)
    return cfg, st, run, out_ff


B1_CASES = cf.b1_cases()
FULL_CASES = [c for c in B1_CASES if not c["name"].startswith("format")]
FORMAT_CASES = [c for c in B1_CASES if c["name"].startswith("format")]


@pytest.mark.parametrize("case", FULL_CASES, ids=[c["name"]
                                                  for c in FULL_CASES])
def test_full_kernel_case(case):
    """tests/test_fuzz_full_kernel.py's invariants on the port (and the
    sps-2, phase_avg-10 case the card phase adds)."""
    cfg, st, run, out_ff = _b1_setup(case)
    _, out = full.demod_block_full(cfg, st, *_planes(run))
    d = full.to_demod_outputs(cfg, out)
    np.testing.assert_array_equal(d.sample_index.numpy(),
                                  out_ff.sample_index.numpy(),
                                  err_msg=str(case))
    np.testing.assert_allclose(d.soft.numpy(), out_ff.soft.numpy(),
                               atol=FUZZ_SOFT_TOL, err_msg=str(case))


@pytest.mark.parametrize("case", FORMAT_CASES,
                         ids=[c["name"] for c in FORMAT_CASES])
def test_format_case(case):
    """tests/test_fuzz_output_formats.py's invariants on the port: the
    option run against the option-free one (bits equal; soft within the
    int8 step and the int16 ingest's bound; phase and sample index equal
    or elided), and the option-free run against the feed-forward one."""
    cfg, st, run, out_ff = _b1_setup(case)
    _, o_base = full.demod_block_full(cfg, st, *_planes(run))
    d_base = full.to_demod_outputs(cfg, o_base)
    np.testing.assert_array_equal(d_base.sample_index.numpy(),
                                  out_ff.sample_index.numpy())
    np.testing.assert_allclose(d_base.soft.numpy(), out_ff.soft.numpy(),
                               atol=FUZZ_SOFT_TOL)

    in_scale, st_opt, x_opt = 1.0, st, _planes(run)
    if case["i16"]:
        in_scale, q_re, q_im = cf.int16_wire(run)
        st_opt = full.quantize_full_state(st, in_scale)
        x_opt = (torch.from_numpy(q_re), torch.from_numpy(q_im))
    scale = cf.FORMAT_SCALE if case["soft_i8"] else None
    _, o_opt = full.demod_block_full(
        cfg, st_opt, *x_opt, in_scale=in_scale, pack_out=case["pack_out"],
        soft_i8_scale=scale, debug_ports=case["debug_ports"])
    d_opt = full.to_demod_outputs(cfg, o_opt, soft_i8_scale=scale)
    np.testing.assert_array_equal(d_opt.bits.numpy(), d_base.bits.numpy())
    soft = d_opt.soft
    if case["soft_i8"]:
        soft = full.QuantSoft(soft.re_q.numpy(), soft.im_q.numpy(),
                              soft.scale)
    else:
        soft = soft.numpy()
    soft = full.dequantize_soft(soft)
    base = d_base.soft.numpy()
    exp_re, exp_im = base.real, base.imag
    if case["soft_i8"]:
        exp_re = np.clip(exp_re, -127 / scale, 127 / scale)
        exp_im = np.clip(exp_im, -127 / scale, 127 / scale)
    tol = ((0.5 / scale if case["soft_i8"] else 0.0)
           + (5e-3 if case["i16"] else 1e-6))
    np.testing.assert_allclose(soft.real, exp_re, atol=tol + 1e-7)
    np.testing.assert_allclose(soft.imag, exp_im, atol=tol + 1e-7)
    if case["debug_ports"]:
        if case["i16"]:
            np.testing.assert_allclose(d_opt.phase.numpy(),
                                       d_base.phase.numpy(), atol=5e-3)
        else:
            np.testing.assert_array_equal(d_opt.phase.numpy(),
                                          d_base.phase.numpy())
        np.testing.assert_array_equal(d_opt.sample_index.numpy(),
                                      d_base.sample_index.numpy())
    else:
        assert d_opt.phase is None and d_opt.sample_index is None


def _valid_cat(outs, field):
    return np.concatenate([np.asarray(getattr(o, field))[np.asarray(o.valid)]
                           for o in outs])


@pytest.mark.parametrize("case", cf.EQUIV_CASES, ids=[
    f"sps{c['sps']}M{c['constellation_size']}A{c['num_avg']}"
    f"P{c['phase_avg']}{'d' if c['differential'] else ''}-{i}"
    for i, c in enumerate(cf.EQUIV_CASES)])
def test_equivalence_case(case):
    """tests/test_fuzz_equiv.py on the port: the exact scan and the
    feed-forward pipeline over the case's ragged blocks agree with each
    other, and each equals its JAX counterpart block by block."""
    kw = cf.case_cfg(case)
    cfg, jcfg = DemodConfig(**kw), JaxDemodConfig(**kw)
    blocks = cf.equiv_blocks(case, cfg.sps)
    runs = {}
    for name, fn, init, jfn, jinit in (
            ("exact", pst.make_demod_fn(cfg),
             pst.demod_init(cfg, device="cpu"),
             jpst.make_demod_fn(jcfg), jpst.demod_init(jcfg)),
            ("ff", blockpsk.make_ff_demod_fn(cfg),
             blockpsk.ff_init(cfg, None, "cpu"),
             jblockpsk.make_ff_demod_fn(jcfg), jblockpsk.ff_init(jcfg))):
        st, jst, outs = init, jinit, []
        for blk in blocks:
            st, out = fn(st, blk)
            jst, jout = jfn(jst, jnp.asarray(blk))
            jout = to_host(jout)
            np.testing.assert_array_equal(out.valid.numpy(),
                                          np.asarray(jout.valid))
            v = out.valid.numpy()
            for f in ("bits", "sample_index", "soft", "phase"):
                a = getattr(out, f).numpy()[v]
                b = np.asarray(getattr(jout, f))[v]
                if f in ("bits", "sample_index"):
                    np.testing.assert_array_equal(a, b, err_msg=f"{name} {f}")
                else:
                    np.testing.assert_allclose(a, b, atol=EXACT_TOL,
                                               err_msg=f"{name} {f}")
            outs.append(out)
        runs[name] = outs
    for e, f in zip(*runs.values()):
        np.testing.assert_array_equal(e.valid.numpy(), f.valid.numpy())
    np.testing.assert_allclose(_valid_cat(runs["ff"], "soft"),
                               _valid_cat(runs["exact"], "soft"),
                               atol=FUZZ_SOFT_TOL)
    np.testing.assert_array_equal(_valid_cat(runs["ff"], "bits"),
                                  _valid_cat(runs["exact"], "bits"))


def _first_max(idx, valid=None):
    idx = np.asarray(idx)
    if valid is not None:
        idx = idx[np.asarray(valid)]
    return idx.size > 0 and bool(np.all(idx == 0))


def test_tie_exact_and_ff_first_max():
    """tests/test_tiebreak.py:31-46: sample index 0 on exact ties from the
    exact scan and the feed-forward pipeline, as the JAX package's."""
    kw = cf.TIE_CFG
    cfg, jcfg = DemodConfig(**kw), JaxDemodConfig(**kw)
    x = cf.tie_signal(256, cfg.sps, 4)
    _, out = pst.make_demod_fn(cfg)(pst.demod_init(cfg, device="cpu"), x)
    _, jout = jpst.make_demod_fn(jcfg)(jpst.demod_init(jcfg), x)
    jout = to_host(jout)
    assert _first_max(out.sample_index.numpy(), out.valid.numpy())
    assert _first_max(jout.sample_index, jout.valid)
    _, out = blockpsk.make_ff_demod_fn(cfg, channels=1)(
        blockpsk.ff_init(cfg, 1, "cpu"), x[None])
    _, jout = jblockpsk.make_ff_demod_fn(jcfg, channels=1)(
        jblockpsk.ff_init(jcfg, (1,)), x[None])
    jout = to_host(jout)
    assert _first_max(out.sample_index.numpy(), out.valid.numpy())
    assert _first_max(jout.sample_index, jout.valid)


@pytest.mark.parametrize("sps", [8, 10])
def test_tie_b1_first_max(sps):
    """tests/test_tiebreak.py:49-68: B1's plain version picks sample 0 on
    every symbol of the exact-tie signal."""
    cfg = DemodConfig(**dict(cf.TIE_CFG, sps=sps))
    x = np.stack([cf.tie_signal(512, sps, 4, seed=i) for i in range(C)])
    warm, run = np.split(x, [128 * sps], axis=1)
    fn = blockpsk.make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn(blockpsk.ff_init(cfg, C, "cpu"), torch.from_numpy(warm))
    _, out = full.demod_block_full(cfg, full.full_from_ff(cfg, st_ff),
                                   *_planes(run))
    assert bool((out.sample_index == 0).all())


def test_shifted_tie_prefers_lower_index():
    """tests/test_tiebreak.py:71-89 through the port's exact scan and the
    JAX one: a constant stream delayed 3 samples ties every bin."""
    kw = dict(sps=8, num_avg=16, constellation_size=2, phase_avg=8)
    x = np.concatenate([np.zeros(3, np.complex64),
                        np.ones(256 * 8, np.complex64)])[:256 * 8]
    for out in (pst.make_demod_fn(DemodConfig(**kw))(
                    pst.demod_init(DemodConfig(**kw), device="cpu"), x)[1],
                to_host(jpst.make_demod_fn(JaxDemodConfig(**kw))(
                    jpst.demod_init(JaxDemodConfig(**kw)), x)[1])):
        idx = np.asarray(out.sample_index)[np.asarray(out.valid)]
        assert _first_max(idx[kw["num_avg"]:])


def test_reconfigure_ff_matches_loop_oracle_and_jax():
    """tests/test_fuzz_full_kernel.py:105-138 on the port: the
    right-aligned phase-history gather of runtime/engine_stream.
    reconfigure_ff equals the JAX test's per-channel loop oracle over the
    same random counts and window sizes."""
    from psk_soft_tpu_torch.runtime.engine_stream import reconfigure_ff

    rng = np.random.default_rng(7)
    for _ in range(50):
        n_old, n_new = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        cc = int(rng.integers(1, 6))
        ell, m = max(n_old - 1, 0), max(n_new - 1, 0)
        hist = rng.standard_normal((cc, ell)).astype(np.float32)
        count = np.minimum(rng.integers(0, n_old + 1, cc),
                           max(n_old - 1, 1)).astype(np.int32)
        keep = np.minimum(count, m)
        want = np.zeros((cc, m), np.float32)
        if n_new > 1 and n_old > 1:
            for ch in range(cc):
                k = int(keep[ch])
                if k > 0:
                    live = hist[ch][ell - min(int(count[ch]), ell):]
                    nh = live[max(live.size - k, 0):]
                    want[ch][m - nh.size:] = nh
        kw = dict(sps=8, num_avg=20, constellation_size=4)
        old, new = (DemodConfig(**kw, phase_avg=n) for n in (n_old, n_new))
        st = blockpsk.ff_init(old, cc, "cpu")._replace(
            phase_hist=torch.from_numpy(hist),
            phase_count=torch.from_numpy(count))
        got = reconfigure_ff(old, new, st).phase_hist.numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{n_old}->{n_new}")
