"""Runnable BASELINE.json evaluation configs 1-5 (port of
``psk_soft_tpu/eval/baseline_configs.py``).

Each returns a JSON-able summary dict; the CLI exposes them as
``python -m psk_soft_tpu_torch baseline --config N``.  ``quick`` shrinks
sizes so every config also runs on the CPU (the full sizes match
BASELINE.md).  Config 5 shards over a mesh of the device it is given
(parallel/): one card is a 1 x 1 mesh, and ``devices`` names more shards.
"""

from __future__ import annotations

import numpy as np

from ..config import DemodConfig


def config1_golden_bpsk(quick: bool = True, device="cuda") -> dict:
    """(1) Single-channel BPSK, 8 sps, the reference test fixture, through
    the exact scan."""
    from ..models.psk import demod_init, make_demod_fn
    from ..testing.signals import gen_psk
    from ..utils.transfer import to_device, to_host

    nsym = 1000
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=2, phase_avg=50)
    x, syms = gen_psk(nsym, 8, 2)
    st, out = make_demod_fn(cfg)(demod_init(cfg, device=device),
                                 to_device(x, device))
    out = to_host(out)
    soft = out.soft[out.valid]
    exp = syms[: soft.size]
    err = min(np.abs(soft[1:] * np.exp(1j * t) - exp[1:]).max()
              for t in (0, np.pi))
    return {"config": 1, "symbols": int(soft.size),
            "max_soft_error": float(err), "bound": 1e-3,
            "pass": bool(err < 1e-3)}


def config2_qpsk_freq_offset(quick: bool = True, device="cuda") -> dict:
    """(2) QPSK at 10 sps with frequency offset: full carrier recovery."""
    from .ber import measure_ber, theoretical_ber

    cfg = DemodConfig(sps=10, num_avg=50, constellation_size=4, phase_avg=50)
    nsym = 20000 if quick else 100000
    pt = measure_ber(cfg, esn0_db=12.0, num_symbols=nsym, seed=2,
                     freq_offset=2e-4, device=device)
    th = float(theoretical_ber(4, np.array([12.0]))[0])
    return {"config": 2, "esn0_db": 12.0, "freq_offset": 2e-4,
            "ber": pt.ber, "theory_ber": th, "n_bits": pt.n_bits,
            "pass": bool(pt.ber < 10 * th + 2e-4)}


def config3_8psk_rrc_sweep(quick: bool = True, device="cuda") -> dict:
    """(3) 8-PSK + RRC matched filter + early-late timing, Es/N0 sweep."""
    from .ber import ber_sweep

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=8, phase_avg=40,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
                      timing_interp=True)
    esn0 = [10.0, 14.0, 18.0] if quick else list(np.arange(8.0, 21.0, 2.0))
    nsym = 12000 if quick else 50000
    pts = ber_sweep(cfg, esn0, num_symbols=nsym, pulse="rrc", seed=9,
                    device=device)
    return {"config": 3,
            "sweep": [{"esn0_db": p.esn0_db, "ber": p.ber, "ser": p.ser}
                      for p in pts],
            "pass": bool(pts[-1].ber < 2e-4)}


def config4_mixed_64ch(quick: bool = True, device="cuda") -> dict:
    """(4) 64-channel mixed BPSK/QPSK/8PSK batched demod on one card."""
    from ..models.mixed import MixedParams, make_mixed_demod_fn, mixed_init
    from ..testing.signals import gen_psk_channel
    from ..utils.transfer import to_device, to_host

    C, nsym = 64, 400 if quick else 4000
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    rng = np.random.default_rng(4)
    ms = rng.choice([2, 4, 8], C)
    diffs = rng.integers(0, 2, C).astype(bool)
    xs = np.stack([
        gen_psk_channel(nsym, sps=8, m=int(ms[c]), differential=bool(diffs[c]),
                        seed=c, snr_db=25.0)[0] for c in range(C)])
    fn = make_mixed_demod_fn(cfg)
    st, out = fn(MixedParams.make(ms, diffs, device=device),
                 mixed_init(cfg, C, device), to_device(xs, device))
    out = to_host(out)
    worst = 0.0
    for c in range(C):
        s = out.soft[c][out.valid[c]][50:]
        m = int(ms[c])
        ang = np.angle(s) - (np.pi / 4 if m == 4 else 0.0)
        slot = ang * m / (2 * np.pi)
        err = float(np.percentile(np.abs(slot - np.round(slot)), 95))
        worst = max(worst, err)
    return {"config": 4, "channels": C, "worst_p95_slot_error": worst,
            "pass": bool(worst < 0.25)}


def config5_sharded_qpsk(quick: bool = True, device="cuda",
                         devices=None) -> dict:
    """(5) Many-channel QPSK sharded over a mesh (time + channel axes,
    overlap-save seams via collectives); asserts seam invariance against a
    single-device run.  The mesh is sized from the shard devices, as JAX's
    from ``jax.devices()``: ``devices`` (default ``[device]``, one card a
    1 x 1 mesh)."""
    import torch

    from ..models.blockpsk import ff_init, make_ff_demod_fn
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import make_sharded_demod
    from ..utils.transfer import to_device, to_host

    devices = [device] if devices is None else list(devices)
    n_dev = len(devices)
    time_ax = 2 if n_dev >= 2 else 1
    chan_ax = max(n_dev // time_ax, 1)
    C = 64 * chan_ax if quick else 4096
    NS = 1024
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
    rng = np.random.default_rng(5)
    j = rng.integers(0, 4, (C, NS))
    xs = np.zeros((C, NS * 8), np.complex64)
    xs[:, 3::8] = np.exp(2j * np.pi * j / 4)
    xs += (0.01 * rng.standard_normal(xs.shape)).astype(np.complex64)

    dev0 = torch.device(devices[0])
    fn1 = make_ff_demod_fn(cfg, channels=C)
    _, out1 = fn1(ff_init(cfg, C, dev0), to_device(xs, dev0))
    mesh = make_mesh(chan=chan_ax, time=time_ax, devices=devices)
    run = make_sharded_demod(cfg, mesh, NS)
    out2 = run(to_device(xs, dev0))
    h1, h2 = to_host(out1), to_host(out2)
    d = np.abs(h2.soft[h2.valid] - h1.soft[h1.valid]).max()
    bits_eq = bool(np.array_equal(h2.bits[h2.valid], h1.bits[h1.valid]))
    return {"config": 5, "channels": C, "mesh": [chan_ax, time_ax],
            "max_soft_diff_vs_single_device": float(d),
            "bits_equal": bits_eq,
            "pass": bool(d < 1e-3 and bits_eq)}


RUNNERS = {1: config1_golden_bpsk, 2: config2_qpsk_freq_offset,
           3: config3_8psk_rrc_sweep, 4: config4_mixed_64ch,
           5: config5_sharded_qpsk}


def run_config(n: int, quick: bool = True, device="cuda") -> dict:
    return RUNNERS[n](quick=quick, device=device)
