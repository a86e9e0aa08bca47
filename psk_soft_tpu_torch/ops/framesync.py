"""Unique-word frame synchronization + M-fold ambiguity resolution, the
device core of the receive chain (port of
``psk_soft_tpu/ops/framesync.py:53-240, 398-638``).

A known unique word (UW) in the soft stream gives frame alignment and
resolves the M-fold rotation ambiguity of M-th-power carrier recovery:

- **Correlation** c[t] = sum_u conj(uw[u]) * s[t+u], normalized by the
  windowed energy, |c[t]| / sqrt(U * E[t]) (scale-free, in [0, 1]).
- **Detection**: local maxima of the normalized correlation at or above
  the threshold (the ``detect_peaks`` criterion).
- **Ambiguity**: the correlation's phase at a peak quantizes to the M-fold
  grid, k = round(angle(c) * M / 2pi); the payload is derotated by
  exp(-j*2pi*k/M).

:func:`sync_extract_topk_tm` is written for the GPU: an unfold-and-matvec
correlation, sliding maxima over an unfolded window, an exclusive cumsum
rank of the peaks, one scatter of the earliest ``k`` peaks per channel and
one gather of their payload rows.  The TPU formulation (banded-MXU
correlation, log-doubling maxima, one-hot radix payload extraction) is not
carried over; the results are the same up to float summation order.

The streaming host path of the JAX module (``correlate_uw``,
``detect_peaks``, ``extract_frames``, sparse detection) waits for ROADMAP
A.7.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

_MAX_UW = 256


def psk_points(idx, m: int) -> np.ndarray:
    """Ideal soft-port constellation points for symbol indices: angle
    2*pi*k/M, plus pi/4 for QPSK (applied in differential mode too)."""
    idx = np.asarray(idx, np.int64)
    if (idx < 0).any() or (idx >= m).any():
        raise ValueError(f"symbol indices must lie in [0, {m})")
    rot = np.pi / 4 if m == 4 else 0.0
    return np.exp(1j * (2 * np.pi * idx / m + rot)).astype(np.complex64)


def uw_points(uw, m: int) -> np.ndarray:
    """:func:`psk_points` with UW shape validation."""
    uw = np.asarray(uw, np.int64)
    if uw.ndim != 1 or uw.size == 0:
        raise ValueError("uw must be a non-empty 1-D index sequence")
    if uw.size > _MAX_UW:
        raise ValueError(f"uw longer than {_MAX_UW} symbols")
    return psk_points(uw, m)


@dataclasses.dataclass(frozen=True)
class FrameFormat:
    """Frame structure: UW symbol indices + payload length (symbols).

    Attributes:
      uw: tuple of symbol indices in [0, M) (decoded-symbol space).
      payload: payload symbols following the UW.
      m: constellation size the stream was demodulated with.
      threshold: normalized-correlation detection threshold in (0, 1];
        the false-alarm rate per position against random M-PSK fill is
        about exp(-(threshold^2) * U), so size the UW with
        threshold^2 * U >~ 14 (e.g. U=32 at 0.7).
      min_sep: minimum symbols between detected frame starts (default:
        the whole frame, UW + payload).
    """

    uw: tuple
    payload: int
    m: int = 4
    threshold: float = 0.6
    min_sep: int | None = None

    def __post_init__(self):
        uw_points(self.uw, self.m)       # validates
        if self.payload < 0:
            raise ValueError("payload must be >= 0")
        if not (0.0 < self.threshold <= 1.0):
            raise ValueError("threshold must be in (0, 1]")

    @property
    def uw_len(self) -> int:
        return len(self.uw)

    @property
    def frame_len(self) -> int:
        return self.uw_len + self.payload

    @property
    def separation(self) -> int:
        return self.min_sep if self.min_sep is not None else self.frame_len

    @functools.cached_property
    def points(self) -> np.ndarray:
        return uw_points(self.uw, self.m)


@dataclasses.dataclass
class Frame:
    """One synchronized frame.

    start is the absolute symbol index of the UW's first symbol in the
    channel's soft stream; rotation is the resolved M-fold ambiguity index
    k (payload derotated by exp(-j*2pi*k/M) before slicing).
    """

    channel: int
    start: int
    rotation: int
    corr: float
    residual_phase: float
    soft: np.ndarray | None      # (payload,) derotated complex payload
    bits: np.ndarray | None      # (payload * log2(M),) int8, LSB-first
    info_bits: np.ndarray | None = None  # decoded information bits
    corrected: int = 0                   # channel errors the code absorbed
    suspect: bool = False                # re-encode mismatch
    crc_ok: bool | None = None


class SyncResult(typing.NamedTuple):
    """Fixed-capacity sync output of :func:`sync_extract_topk` (and the
    time-major core).  Rows where ``found`` is False are garbage (the
    fixed-capacity contract); ``count`` is the total number of committable
    peaks per channel, including any beyond the ``k`` extracted, so
    ``count > k`` shows that the cap dropped frames."""

    payloads: torch.Tensor   # (C, k, payload) complex64, derotated
    found: torch.Tensor      # (C, k) bool
    pos: torch.Tensor        # (C, k) int32 UW start positions
    ang: torch.Tensor        # (C, k) float32 raw correlation angles
    count: torch.Tensor      # (C,) int32 total committable peaks


def sync_extract_topk(soft: torch.Tensor, fmt: FrameFormat, k: int, *,
                      commit_lo: int | None = None,
                      commit_hi: int | None = None) -> SyncResult:
    """Fixed-capacity frame sync for one (C, S) complex soft block: the
    earliest ``k`` UW peaks per channel inside the commit window (default
    [0, S - frame_len]), payloads derotated.  Thin wrapper over
    :func:`sync_extract_topk_tm`."""
    return sync_extract_topk_tm(soft.real.T, soft.imag.T, fmt, k,
                                commit_lo=commit_lo, commit_hi=commit_hi)


def sync_extract_topk_tm(soft_re: torch.Tensor, soft_im: torch.Tensor,
                         fmt: FrameFormat, k: int, *,
                         commit_lo: int | None = None,
                         commit_hi: int | None = None) -> SyncResult:
    """Time-major core: (S, C) float32 soft planes (the demod kernel's
    layout) in, :class:`SyncResult` with channels leading out.

    A peak at t satisfies norm[t] >= threshold, norm[t] > every value in
    the ``sep - 1`` positions before it and norm[t] >= every value in the
    ``sep - 1`` positions after it (first-max tie-break).  Only peaks with
    commit_lo <= t <= commit_hi commit; ``commit_hi`` may not leave the
    payload outside the block.  A slot that found nothing reports pos 0,
    ang 0 and the payload rows after position 0, not derotated.
    """
    u = fmt.uw_len
    s, c_dim = soft_re.shape
    if s < fmt.frame_len:
        raise ValueError(f"block shorter ({s}) than one frame "
                         f"({fmt.frame_len})")
    dev = soft_re.device
    uw_conj = np.conj(np.asarray(fmt.points, np.complex64))
    ur = torch.as_tensor(np.ascontiguousarray(uw_conj.real), device=dev)
    ui = torch.as_tensor(np.ascontiguousarray(uw_conj.imag), device=dev)
    w = s - u + 1

    # Correlation: (W, C, U) windows times the UW, as matrix-vector
    # products in float32.
    win_re = soft_re.unfold(0, u, 1)
    win_im = soft_im.unfold(0, u, 1)
    acc_r = win_re @ ur - win_im @ ui                  # (W, C)
    acc_i = win_im @ ur + win_re @ ui
    p = soft_re * soft_re + soft_im * soft_im
    cs = torch.cat([torch.zeros((1, c_dim), dtype=p.dtype, device=dev),
                    torch.cumsum(p, dim=0)])
    energy = cs[u:] - cs[:-u]
    norm = torch.hypot(acc_r, acc_i) / torch.sqrt(
        torch.clamp(u * energy, min=1e-20))

    sep = max(int(fmt.separation), 1)
    is_peak = norm >= fmt.threshold                   # compared in float32
    if sep > 1:
        wwin = sep - 1
        pad = torch.full((wwin, c_dim), -torch.inf, dtype=norm.dtype,
                         device=dev)
        ext = torch.cat([pad, norm, pad])             # (W + 2*wwin, C)
        wmax = ext.unfold(0, wwin, 1).amax(dim=-1)    # max over wwin rows
        left = wmax[:w]                               # (t-wwin .. t-1)
        right = wmax[wwin + 1:wwin + 1 + w]           # (t+1 .. t+wwin)
        is_peak = is_peak & (norm > left) & (norm >= right)

    lo = 0 if commit_lo is None else int(commit_lo)
    hi = s - fmt.frame_len if commit_hi is None else int(commit_hi)
    if hi > s - fmt.frame_len:
        raise ValueError(f"commit_hi {hi} leaves the payload outside the "
                         f"block (max {s - fmt.frame_len})")
    t = torch.arange(w, device=dev)[:, None]
    is_peak = is_peak & (t >= lo) & (t <= hi)
    ipk = is_peak.to(torch.int32)
    count = ipk.sum(dim=0, dtype=torch.int32)          # (C,)
    rnk = torch.cumsum(ipk, dim=0) - ipk               # exclusive rank

    # Earliest k peaks: scatter each peak's position into slot rnk (slot k
    # collects the peaks beyond the capacity and every non-peak).
    slot = torch.where(is_peak & (rnk < k), rnk, k).to(torch.int64)
    pos_buf = torch.zeros((k + 1, c_dim), dtype=torch.int64, device=dev)
    pos_buf.scatter_(0, slot, t.expand(w, c_dim).contiguous())
    hit = torch.zeros((k + 1, c_dim), dtype=torch.bool, device=dev)
    hit.scatter_(0, slot, torch.ones_like(is_peak))
    pos = pos_buf[:k]                                  # (k, C)
    found = hit[:k]
    pos = torch.where(found, pos, torch.zeros_like(pos))
    cv_r = torch.where(found, torch.gather(acc_r, 0, pos),
                       torch.zeros((), dtype=acc_r.dtype, device=dev))
    cv_i = torch.where(found, torch.gather(acc_i, 0, pos),
                       torch.zeros((), dtype=acc_i.dtype, device=dev))
    ang = torch.atan2(cv_i, cv_r)                      # (k, C)
    rot = (-2.0 * np.pi / fmt.m) * torch.round(ang * (fmt.m / (2 * np.pi)))
    cr, si = torch.cos(rot), torch.sin(rot)

    # Payload rows pos+U .. pos+U+P-1 of every slot: one gather.
    rows = pos[:, None, :] + u + torch.arange(
        fmt.payload, device=dev)[None, :, None]        # (k, P, C)
    rows = rows.reshape(-1, c_dim)
    pm_r = torch.gather(soft_re, 0, rows).reshape(k, fmt.payload, c_dim)
    pm_i = torch.gather(soft_im, 0, rows).reshape(k, fmt.payload, c_dim)
    out_r = pm_r * cr[:, None, :] - pm_i * si[:, None, :]
    out_i = pm_r * si[:, None, :] + pm_i * cr[:, None, :]
    payloads = torch.complex(out_r, out_i).permute(2, 0, 1)   # (C, k, P)
    return SyncResult(payloads, found.T, pos.T.to(torch.int32), ang.T,
                      count)
