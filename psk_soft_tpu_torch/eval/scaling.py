"""Sharding-cost harness: the three scaling reports of the JAX package
(port of ``psk_soft_tpu/eval/scaling.py:1-319``), on a mesh of shard
devices.

Three reports:

* :func:`channel_scaling_report` -- weak scaling over the
  communication-free ``chan`` axis (constant channels per shard).
  Efficiency_n = t_1 / t_n.
* :func:`chain_scaling_report` -- the same for the whole receive chain
  per shard: B1, then the seam tail (frame sync, LLRs, B2, CRC).
* :func:`time_shard_report` -- the time-sharded single-kernel path
  (parallel/sharded_full.make_time_sharded_full_demod): seam overhead
  (halo exchange + all_gather origin combine) as a function of the
  per-shard block size, fixed total symbols (strong scaling over time).
  Efficiency_n = t_1 / (t_n * n).

``devices`` lists the shard devices (default: this process's CUDA
devices); it may repeat one, as ``["cuda:0"] * 4``.  Each report says
whether its shards share a device (``shards_share_device``): then the
shards run one after another on that device, and the "efficiency"
measures what sharding costs, not how the work scales over devices.

Timing discipline: JAX's ``lax.scan`` of k steps under ``jit`` becomes a
loop of k calls whose checksum (data-dependent on every output) is read
with ``.item()`` at the end, so queued launches cannot inflate the rates.
Reports carry per-point step seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import DemodConfig
from ..parallel.mesh import (P, NamedSharding, local_devices, make_mesh,
                             shard, shard_map)


def _timed_best(run, reps: int) -> float:
    """Best wall time of `run()` (which must end in a host fetch)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def _gen_bank(C: int, S: int, sps: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    sym = rng.integers(0, m, size=(C, S))
    pts = np.exp(1j * (2 * np.pi * sym / m
                       + 2 * np.pi * 1e-4 * np.arange(S)))
    x = np.repeat(pts, sps, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


def _devices(devices) -> list:
    return local_devices() if devices is None else [torch.device(d)
                                                    for d in devices]


def _shared(devices: list, counts) -> bool:
    n = max(counts)
    return len(set(devices[:n])) < n


def _total(*outs) -> torch.Tensor:
    """Sum of every part of sharded outputs, on the first part's device."""
    parts = [p for o in outs for p in o.parts.values()]
    dev = parts[0].device
    return sum(p.sum().to(dev) for p in parts)


def _planes(x_np: np.ndarray, sharding):
    return (shard(torch.from_numpy(np.ascontiguousarray(x_np.real.T)),
                  sharding),
            shard(torch.from_numpy(np.ascontiguousarray(x_np.imag.T)),
                  sharding))


def channel_scaling_report(cfg: DemodConfig, *, device_counts=None,
                           channels_per_device: int = 256,
                           symbols: int = 256, iters: int = 10,
                           reps: int = 3, pipeline: str = "ff",
                           devices=None) -> dict:
    """Weak-scaling report over the chan axis (see module docstring).

    pipeline: "ff" (plain-torch feed-forward) or "full" (kernel B1 on CUDA
    shards, its plain version on CPU ones).
    """
    from ..models.blockpsk import FFState, demod_block_ff, ff_init
    from ..models.psk import DemodOutputs
    from ..utils.transfer import to_device

    devices = _devices(devices)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devices)]
    sps = cfg.sps
    T = symbols * sps
    points = []
    for n in device_counts:
        C = channels_per_device * n
        mesh = make_mesh(chan=n, devices=devices[:n])
        x_np = _gen_bank(C, symbols, sps, cfg.constellation_size)
        if pipeline == "full":
            from ..models.blockpsk import make_ff_demod_fn
            from ..models.full import full_from_ff, window_rows
            from ..parallel.sharded_full import (channel_sharding_tm,
                                                 make_sharded_full_demod,
                                                 shard_full_state)
            warm = make_ff_demod_fn(cfg, channels=C)
            st_ff, _ = warm(ff_init(cfg, C, devices[0]),
                            to_device(x_np, devices[0]))
            raw = (x_np[:, x_np.shape[1] - window_rows(cfg):]
                   if cfg.matched_filter != "none" else None)
            state = shard_full_state(full_from_ff(cfg, st_ff, raw_win=raw),
                                     mesh)
            fn = make_sharded_full_demod(cfg, mesh)
            x_re, x_im = _planes(x_np, channel_sharding_tm(mesh))

            def run_k(state, k):
                chk = 0
                for _ in range(k):
                    state, out = fn(state, x_re, x_im)
                    chk = chk + _total(out.phase, out.soft_re)
                return state, float(chk.item())
        else:
            chan = P("chan")
            state = FFState(*(shard(v, NamedSharding(mesh, chan))
                              for v in ff_init(cfg, C, "cpu")))
            x = shard(torch.from_numpy(x_np), NamedSharding(mesh, chan))
            step = shard_map(
                lambda st, xb: demod_block_ff(cfg, st, xb), mesh,
                in_specs=(FFState(*(chan,) * len(FFState._fields)), chan),
                out_specs=(FFState(*(chan,) * len(FFState._fields)),
                           DemodOutputs(*(chan,) * 5)),
                collectives=False)

            def run_k(state, k):
                chk = 0
                for _ in range(k):
                    state, out = step(state, x)
                    chk = chk + _total(out.phase) + sum(
                        p.real.sum().to(devices[0])
                        for p in out.soft.parts.values())
                return state, float(chk.item())

        state, _ = run_k(state, 1)           # kernels built + warm

        def run():
            nonlocal state
            state, _ = run_k(state, iters)

        t = _timed_best(run, reps) / iters
        points.append({"devices": n, "channels": C, "step_s": t,
                       "throughput_sps": C * T / t})
    t1 = points[0]["step_s"]
    for p in points:
        p["efficiency"] = t1 / p["step_s"]
    return {"mode": "channel-weak", "pipeline": pipeline,
            "symbols_per_block": symbols, "sps": sps,
            "channels_per_device": channels_per_device, "points": points,
            "shards_share_device": _shared(devices, device_counts)}


def chain_scaling_report(cfg: DemodConfig, *, device_counts=None,
                         channels_per_device: int = 128,
                         symbols: int = 512, iters: int = 5,
                         reps: int = 3, devices=None) -> dict:
    """Weak-scaling report for the FULL receive chain per shard: B1 ->
    the seam tail (fixed-capacity frame sync, LLRs, B2 at K=7 rate 1/2,
    CRC16) composed inside the shard body, so the chan axis stays
    communication-free end to end (every post-demod stage is per-channel
    independent).
    """
    from ..models.blockpsk import ff_init, make_ff_demod_fn
    from ..models.chain import SeamTailState, make_seam_tail_fn, \
        seam_tail_init
    from ..models.full import FullState, demod_block_full, full_from_ff
    from ..ops import tx
    from ..ops.crc import CRC16_CCITT
    from ..ops.fec import CODE_K7, info_bits_for
    from ..ops.framesync import FrameFormat
    from ..utils.transfer import to_device

    devices = _devices(devices)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devices)]
    sps, m = cfg.sps, cfg.constellation_size
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(12)
    fmt = FrameFormat(uw=tuple(rng.integers(0, m, 32)), payload=64, m=m,
                      threshold=0.7)
    nb = int(np.log2(m))
    n_info = info_bits_for(code, fmt.payload * nb)
    n_msg = n_info - crc.degree
    a1 = cfg.num_avg - 1
    cadence = 128
    starts, p = [], (-a1) % cadence
    while p + a1 + fmt.frame_len <= symbols:
        starts.append(p)
        p += cadence
    k_frames = len(starts)
    if not k_frames:
        raise ValueError("symbols too small for one frame per block")
    # One frame pattern tiled across channels (identical chain work per
    # channel; per-channel noise below keeps the signal non-degenerate).
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    idx_row = tx.frame_stream(fmt, infos, starts, symbols, code=code,
                              crc=crc, labeling="gray", seed=7)
    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling="gray")

    def body(state, tail, x_re, x_im):
        st2, fo = demod_block_full(cfg, state, x_re, x_im,
                                   debug_ports=False)
        tail2, out = tail_step(tail, fo.soft_re, fo.soft_im)
        chk = (out.msg.to(torch.int32).sum() + out.found.sum()
               + out.ok.sum() + out.pos.sum() + out.count.sum())
        return st2, tail2, chk.to(torch.float32)[None]  # (1,) per shard

    spec = P(None, "chan")
    state_specs = FullState(win_re=spec, win_im=spec, planes=spec)
    tail_specs = SeamTailState(tail_re=spec, tail_im=spec)
    points = []
    for n in device_counts:
        C = channels_per_device * n
        mesh = make_mesh(chan=n, devices=devices[:n])
        x_np = np.repeat(np.exp(1j * (2 * np.pi
                                      * np.tile(idx_row, (C, 1)) / m
                                      + 0.4)), sps, axis=1)
        x_np = (x_np + 0.01 * (np.random.default_rng(n).standard_normal(
            x_np.shape))).astype(np.complex64)
        warm = make_ff_demod_fn(cfg, channels=C)
        st_ff, _ = warm(ff_init(cfg, C, devices[0]),
                        to_device(x_np, devices[0]))
        sh = NamedSharding(mesh, spec)
        state = FullState(*(shard(v, sh) for v in full_from_ff(cfg, st_ff)))
        tail = SeamTailState(*(shard(v, sh) for v in seam_tail_init(
            fmt, C, devices[0])))
        sharded = shard_map(body, mesh,
                            in_specs=(state_specs, tail_specs, spec, spec),
                            out_specs=(state_specs, tail_specs, P("chan")),
                            collectives=False)
        x_re, x_im = _planes(x_np, sh)

        def run_k(carry, k):
            chk = 0
            for _ in range(k):
                st2, t2, c = sharded(carry[0], carry[1], x_re, x_im)
                carry = (st2, t2)
                chk = chk + _total(c)
            return carry, float(chk.item())

        carry, _ = run_k((state, tail), 1)   # kernels built + warm

        def run():
            nonlocal carry
            carry, _ = run_k(carry, iters)

        t = _timed_best(run, reps) / iters
        points.append({
            "devices": n, "channels": C, "step_s": t,
            "throughput_sps": C * symbols * sps / t,
            "infobits_per_s": C * k_frames * n_info / t,
        })
    t1 = points[0]["step_s"]
    for p in points:
        p["efficiency"] = t1 / p["step_s"]
    return {"mode": "chain-weak (seam)", "symbols_per_block": symbols,
            "sps": sps, "channels_per_device": channels_per_device,
            "frames_per_block_per_channel": k_frames,
            "code": "K7 rate 1/2 + CRC16", "points": points,
            "shards_share_device": _shared(devices, device_counts)}


def time_shard_report(cfg: DemodConfig, *, time_counts=None,
                      channels: int = 128, total_symbols: int = 4096,
                      iters: int = 5, reps: int = 3, devices=None) -> dict:
    """Strong-scaling report over the time axis: fixed total symbols split
    across n time shards (chan axis size 1).  Shows the seam overhead (halo
    recompute grows as shards shrink) directly."""
    from ..parallel.sharded_full import make_time_sharded_full_demod

    devices = _devices(devices)
    if time_counts is None:
        time_counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    sps = cfg.sps
    x_np = _gen_bank(channels, total_symbols, sps, cfg.constellation_size)
    points = []
    for n in time_counts:
        mesh = make_mesh(chan=1, time=n, devices=devices[:n])
        fn = make_time_sharded_full_demod(cfg, mesh, total_symbols)
        x_re, x_im = _planes(x_np, NamedSharding(mesh, P("time", "chan")))

        def run_k(k):
            acc = 0
            for _ in range(k):
                sr, _, ph, _, _, _ = fn(x_re, x_im)
                acc = acc + _total(ph, sr)
            return float(acc.item())

        run_k(1)                              # kernels built + warm
        t = _timed_best(lambda: run_k(iters), reps) / iters
        points.append({
            "time_shards": n,
            "symbols_per_shard": total_symbols // n,
            "step_s": t,
            "throughput_sps": channels * total_symbols * sps / t,
        })
    t1 = points[0]["step_s"]
    for p in points:
        p["efficiency"] = t1 / (p["step_s"] * p["time_shards"])
    return {"mode": "time-strong", "channels": channels,
            "total_symbols": total_symbols, "sps": sps, "points": points,
            "shards_share_device": _shared(devices, time_counts)}
