"""Single-kernel steady-state pipeline built on kernel B1
(port of ``psk_soft_tpu/models/full.py:24-398``).

Usage: run the feed-forward pipeline (models/blockpsk) through warm-up,
convert the converged carry with :func:`full_from_ff`, then stream
time-major blocks through :func:`demod_block_full` -- the whole demod is one
kernel launch per block.

The window carry after a block is a view of that block's last rows, so the
"rolling window" of the JAX package (window read in place from the previous
block's planes) is what :func:`demod_block_full` always does: no window
buffer is written or re-read.  :func:`demod_block_full_rolling` keeps the
JAX signature and calls the same launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import DemodConfig
from ..ops.cuda import demod_kernel
from ..ops.phase import UNWRAP_TREND_LEN
from .psk import DemodOutputs


class FullState(NamedTuple):
    # ((num_avg-1)*sps + mf_ntaps-1, C) window rows, float32 or int16
    # (quantize_full_state); raw samples under a matched filter.
    win_re: torch.Tensor
    win_im: torch.Tensor
    planes: torch.Tensor   # (state_rows(phase_avg), C) float32


def window_rows(cfg: DemodConfig) -> int:
    """Rows of the kernel's window carry: (num_avg-1)*sps, plus the
    matched filter's mf_ntaps-1 raw rows of look-back."""
    extra = cfg.mf_ntaps - 1 if cfg.matched_filter != "none" else 0
    return (cfg.num_avg - 1) * cfg.sps + extra


class FullOutputs(NamedTuple):
    """Time-major symbol-rate planes (S, C); bits are packed LSB-first ints.
    soft_re/soft_im are float32, or int8 when the kernel ran with
    ``soft_i8_scale`` (dequantize as ``plane / scale``).  phase and
    sample_index are None with debug ports off."""

    soft_re: torch.Tensor
    soft_im: torch.Tensor
    phase: torch.Tensor | None
    bits_packed: torch.Tensor
    sample_index: torch.Tensor | None


class QuantSoft(NamedTuple):
    """Channel-major int8-quantized soft decisions inside DemodOutputs.soft
    (kernel ``soft_i8_scale`` mode): dequantize as ``(re_q + 1j*im_q) /
    scale``."""

    re_q: torch.Tensor | np.ndarray    # (C, S) int8
    im_q: torch.Tensor | np.ndarray    # (C, S) int8
    scale: float


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def full_from_ff(cfg: DemodConfig, ff_state, raw_win=None,
                 mixed_params=None) -> FullState:
    """Convert a *converged* channel-batched FFState (or FusedState) carry
    to the kernel's carry, on the state's device.  Host-side numpy, called
    once at the warm-up -> steady transition.

    Args:
      raw_win: required under a matched filter: the last
        ``window_rows(cfg)`` RAW input samples per channel, (C, that)
        complex (the kernel filters in-kernel, so its window holds raw
        samples; the FF carry keeps only filtered ones).
      mixed_params: models/mixed.MixedParams of a mixed-mode bank, written
        into the carry's mode rows misc+6 (M) and misc+7 (differential) for
        the kernel's ``mixed`` mode.
    """
    k = UNWRAP_TREND_LEN
    n1 = cfg.phase_avg - 1
    if n1 < k:
        raise ValueError(f"full pipeline requires phase_avg >= {k + 1}")
    device = ff_state.phase_hist.device
    hist = ff_state.phase_hist.cpu().numpy()      # (C, n-1) oldest..newest
    c = hist.shape[0]
    if cfg.matched_filter != "none":
        keep = window_rows(cfg)
        if raw_win is None or tuple(raw_win.shape) != (c, keep):
            raise ValueError(
                f"matched-filter configs need raw_win of shape {(c, keep)} "
                f"(raw input tail; the FF carry only holds filtered samples)")
        raw = _host(raw_win)
        win_re = np.ascontiguousarray(raw.real.T).astype(np.float32)
        win_im = np.ascontiguousarray(raw.imag.T).astype(np.float32)
    elif hasattr(ff_state, "win_re"):             # FusedState (time-major)
        win_re = ff_state.win_re.cpu().numpy()
        win_im = ff_state.win_im.cpu().numpy()
    else:                                         # FFState (channel-major)
        win = ff_state.win_samples.cpu().numpy()  # (C, A-1, sps)
        flat = win.reshape(c, -1)
        win_re = np.ascontiguousarray(flat.real.T).astype(np.float32)
        win_im = np.ascontiguousarray(flat.imag.T).astype(np.float32)

    rs = demod_kernel.state_rows(cfg.phase_avg, k)
    planes = np.zeros((rs, c), np.float32)
    planes[:n1] = hist.T
    tail = hist[:, n1 - (k - 1):]                 # (C, k-1) newest k-1
    planes[n1:n1 + k - 1] = np.cos(tail).T
    planes[n1 + k - 1:n1 + 2 * (k - 1)] = np.sin(tail).T
    misc = n1 + 2 * (k - 1)
    last_k = hist[:, n1 - k:]                     # (C, k)
    ang_prev = np.arctan2(np.sin(last_k).sum(-1), np.cos(last_k).sum(-1))
    last_phase = ff_state.last_phase.cpu().numpy()
    planes[misc] = ang_prev
    planes[misc + 1] = (2 * np.pi) * np.round(
        (last_phase - ang_prev) / (2 * np.pi))
    last_any = ff_state.last_any.cpu().numpy()
    planes[misc + 2] = last_any.real
    planes[misc + 3] = last_any.imag
    if mixed_params is not None:
        planes[misc + 6] = _host(mixed_params.m).astype(np.float32)
        planes[misc + 7] = _host(mixed_params.diff).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return FullState(win_re=to(win_re), win_im=to(win_im), planes=to(planes))


def ff_from_full(cfg: DemodConfig, state: FullState):
    """Convert the kernel carry back to a converged FFState, on the carry's
    device: the inverse of :func:`full_from_ff`, used by the engine's live
    reconfigure.  The state planes are the feed-forward carry in another
    layout: ``planes[:n-1]`` is the unwrapped-phase history (newest ==
    last_phase after the end-of-block re-wrap), ``planes[misc+2/3]`` the
    previous decision sample.  Under a matched filter the raw window is
    filtered here (the ``ops/matched_filter.apply_fir`` convention, float64
    as in the JAX package) and its last mf_ntaps-1 raw samples become the
    filter tail.  An int16 window is dequantized first
    (:func:`dequantize_full_state`).  Host-side numpy, once per property
    change."""
    from .blockpsk import FFState
    from ..ops.matched_filter import filter_taps

    if state.win_re.dtype != torch.float32:
        raise ValueError("ff_from_full takes a float32 window; dequantize an "
                         "int16 one first (dequantize_full_state)")
    if state.win_re.shape[0] != window_rows(cfg):
        raise ValueError(f"the window has {state.win_re.shape[0]} rows, the "
                         f"config needs {window_rows(cfg)} (a matched filter "
                         f"carries mf_ntaps-1 raw rows more)")
    k = UNWRAP_TREND_LEN
    n1 = cfg.phase_avg - 1
    device = state.planes.device
    planes = state.planes.cpu().numpy()
    c = planes.shape[1]
    misc = n1 + 2 * (k - 1)
    raw = (state.win_re.cpu().numpy().T
           + 1j * state.win_im.cpu().numpy().T).astype(np.complex64)
    if cfg.matched_filter != "none":
        taps = np.asarray(filter_taps(cfg), np.float64)
        L = taps.size
        sw = np.lib.stride_tricks.sliding_window_view(raw, L, axis=-1)
        filt = (sw @ taps).astype(np.complex64)             # (C, wlen)
        mf_tail = raw[:, raw.shape[1] - (L - 1):]
        win = filt.reshape(c, cfg.num_avg - 1, cfg.sps)
    else:
        mf_tail = np.zeros((c, 0), np.complex64)
        win = raw.reshape(c, cfg.num_avg - 1, cfg.sps)
    hist = np.ascontiguousarray(planes[:n1].T)    # (C, n-1) oldest..newest
    last_any = (planes[misc + 2] + 1j * planes[misc + 3]).astype(np.complex64)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731,E501
    full_i32 = lambda v: torch.full((c,), v, dtype=torch.int32,  # noqa: E731
                                    device=device)
    return FFState(
        win_samples=to(win),
        win_energy=to((win.real ** 2 + win.imag ** 2).astype(np.float32)),
        seen=full_i32(cfg.num_avg),
        phase_hist=to(hist.astype(np.float32)),
        phase_count=full_i32(cfg.phase_avg),
        last_phase=to(hist[:, -1].astype(np.float32) if n1 > 0
                      else np.zeros(c, np.float32)),
        last_any=to(last_any),
        mf_tail=to(mf_tail.astype(np.complex64)),
    )


def dequantize_full_state(state: FullState, in_scale: float) -> FullState:
    """Inverse of :func:`quantize_full_state`: float32 window planes (for
    ff_from_full and checkpoint interchange); a float32 state as it is."""
    if state.win_re.dtype != torch.int16:
        return state
    return FullState(win_re=state.win_re.to(torch.float32) * in_scale,
                     win_im=state.win_im.to(torch.float32) * in_scale,
                     planes=state.planes)


def quantize_full_state(state: FullState, in_scale: float) -> FullState:
    """The window planes on the int16 wire format (kernel B1's int16
    ingest): ``clip(round(w / in_scale))``; the state planes stay float32.
    A window that came from dequantized int16 input gets its exact wire
    values back."""
    def q(w):
        return torch.clamp(torch.round(w / in_scale), -32768,
                           32767).to(torch.int16)

    return FullState(win_re=q(state.win_re), win_im=q(state.win_im),
                     planes=state.planes)


def _kernel_kwargs(cfg: DemodConfig, mixed, in_scale, pack_out,
                   soft_i8_scale, debug_ports):
    if cfg.sps <= 1:
        raise ValueError("full kernel supports sps > 1; use models.blockpsk "
                         "for the sps=1 passthrough")
    return dict(sps=cfg.sps, num_avg=cfg.num_avg, phase_avg=cfg.phase_avg,
                m=cfg.constellation_size, diff=cfg.differential,
                mf_taps=_static_taps(cfg), timing_interp=cfg.timing_interp,
                mixed=mixed, in_scale=in_scale, pack_out=pack_out,
                soft_i8_scale=soft_i8_scale, debug_ports=debug_ports)


def demod_block_full(cfg: DemodConfig, state: FullState,
                     x_re: torch.Tensor, x_im: torch.Tensor, *,
                     mixed: bool = False, in_scale: float = 1.0,
                     pack_out: bool | None = None,
                     soft_i8_scale: float | None = None,
                     debug_ports: bool = True):
    """One steady-state block through kernel B1.

    x_re/x_im: (T, C) time-major planes of raw input, T = S * sps, with
    T >= window_rows(cfg): float32, or int16 (the wire format, dequantized
    as ``i16 * in_scale`` in the kernel) with an int16-window state
    (:func:`quantize_full_state`).  A matched filter runs inside the kernel.
    ``mixed`` reads each channel's M and differential flag from the carry
    (full_from_ff(..., mixed_params=...)); cfg's are then ignored.  Returns
    (new FullState, FullOutputs); the new window planes are views of the
    block's last rows.
    """
    kw = _kernel_kwargs(cfg, mixed, in_scale, pack_out, soft_i8_scale,
                        debug_ports)
    keep = window_rows(cfg)
    if x_re.shape[0] < keep:
        raise ValueError(
            f"block must be >= (num_avg-1)*sps + mf_ntaps-1 = {keep} "
            f"samples, got {x_re.shape[0]}; pad the final block (see "
            f"FullKernelBatchEngine.flush)")
    soft_re, soft_im, phase, bits, idx, planes = demod_kernel.demod_full_tm(
        state.win_re, state.win_im, x_re, x_im, state.planes, **kw)
    new_state = FullState(win_re=x_re[x_re.shape[0] - keep:],
                          win_im=x_im[x_im.shape[0] - keep:], planes=planes)
    return new_state, FullOutputs(soft_re, soft_im, phase, bits, idx)


def demod_block_full_rolling(cfg: DemodConfig, planes: torch.Tensor,
                             prev_re: torch.Tensor, prev_im: torch.Tensor,
                             x_re: torch.Tensor, x_im: torch.Tensor,
                             **kwargs):
    """Steady-state block with the window taken from the previous block's
    planes (their last ``window_rows(cfg)`` rows, a view); keyword
    arguments as :func:`demod_block_full`.  Returns ``(planes',
    FullOutputs)``."""
    keep = window_rows(cfg)
    if prev_re.shape[0] < keep:
        raise ValueError(f"prev planes must hold >= {keep} rows")
    state = FullState(win_re=prev_re[prev_re.shape[0] - keep:],
                      win_im=prev_im[prev_im.shape[0] - keep:], planes=planes)
    new_state, out = demod_block_full(cfg, state, x_re, x_im, **kwargs)
    return new_state.planes, out


def make_full_demod_fn(cfg: DemodConfig, *, in_scale: float = 1.0,
                       pack_out: bool | None = None,
                       soft_i8_scale: float | None = None):
    """The steady-state step ``fn(state, x_re, x_im) -> (state,
    FullOutputs)``: :func:`demod_block_full` with the options closed over,
    one B1 launch a call.  The JAX ``s_tile``, ``interpret`` and ``jit``
    arguments are TPU-only and not taken (the kernel runs each block
    whole)."""
    return functools.partial(demod_block_full, cfg, in_scale=in_scale,
                             pack_out=pack_out, soft_i8_scale=soft_i8_scale)


def make_mixed_full_demod_fn(cfg: DemodConfig):
    """The mixed-mode step: per-channel (M, differential) read from the
    carry's mode rows (convert with ``full_from_ff(..., mixed_params=
    params)``); cfg's constellation_size and differential are ignored."""
    return functools.partial(demod_block_full, cfg, mixed=True)


def make_scanned_full_demod_fn(cfg: DemodConfig, *, in_scale: float = 1.0,
                               pack_out: bool | None = None,
                               soft_i8_scale: float | None = None):
    """Many block steps in one call: ``fn(state, xs_re, xs_im)`` with
    (K, T, C) plane stacks runs K sequential B1 launches (a loop where JAX
    scans) and returns (state, FullOutputs stacked on a leading K axis)."""
    step = make_full_demod_fn(cfg, in_scale=in_scale, pack_out=pack_out,
                              soft_i8_scale=soft_i8_scale)

    def run(state: FullState, xs_re, xs_im):
        outs = []
        for k in range(xs_re.shape[0]):
            state, out = step(state, xs_re[k], xs_im[k])
            outs.append(out)
        return state, FullOutputs(*(torch.stack(f) for f in zip(*outs)))

    return run


def _static_taps(cfg: DemodConfig):
    """Matched-filter taps as a hashable tuple of floats (None when
    disabled)."""
    from ..ops.matched_filter import filter_taps

    taps = filter_taps(cfg)
    return None if taps is None else tuple(float(t) for t in taps)


def to_demod_outputs(cfg: DemodConfig, out: FullOutputs,
                     soft_i8_scale: float | None = None) -> DemodOutputs:
    """Adapter to the channel-major DemodOutputs.  phase and sample_index
    stay None when the kernel ran with debug ports off.  int8 soft planes
    need the ``soft_i8_scale`` they ran with and come back as a
    :class:`QuantSoft` (still quantized)."""
    if out.soft_re.dtype == torch.int8:
        if soft_i8_scale is None:
            raise ValueError("kernel emitted int8 soft planes; pass the "
                             "soft_i8_scale it ran with")
        soft = QuantSoft(out.soft_re.T, out.soft_im.T, float(soft_i8_scale))
        vshape = soft.re_q.shape
    else:
        soft = torch.complex(out.soft_re.T, out.soft_im.T)
        vshape = soft.shape
    packed = out.bits_packed.T
    bits = torch.stack([(packed >> i) & 1
                        for i in range(max(3, cfg.bits_per_symbol))],
                       dim=-1).to(torch.int8)
    return DemodOutputs(
        soft=soft,
        bits=bits,
        phase=None if out.phase is None else out.phase.T,
        sample_index=(None if out.sample_index is None
                      else out.sample_index.T),
        valid=torch.ones(vshape, dtype=torch.bool,
                         device=out.soft_re.device),
    )


def dequantize_soft(soft) -> np.ndarray:
    """Host-side complex64 soft decisions from a host QuantSoft (identity
    for already-complex arrays)."""
    if isinstance(soft, QuantSoft):
        inv = 1.0 / float(soft.scale)
        out = np.empty(np.shape(soft.re_q), np.complex64)
        out.real = np.asarray(soft.re_q, np.float32) * inv
        out.imag = np.asarray(soft.im_q, np.float32) * inv
        return out
    return np.asarray(soft)
