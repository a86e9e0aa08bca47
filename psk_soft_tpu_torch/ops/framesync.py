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

The streaming path (``psk_soft_tpu/ops/framesync.py:76-397, 641-679``)
shares that correlation and those maxima: :func:`correlate_uw`,
:func:`detect_uw_sparse` (the local-max mask, then one ``torch.nonzero``:
one sync and 16 bytes fetched per candidate), :func:`extract_heads` (one
gather of the committed heads' payload rows, derotated and re-sliced) and
the one-shot :func:`extract_frames`; :func:`detect_peaks` is the host
(numpy) criterion they all implement.  The JAX module's power-of-two
bucket padding (a jit-cache device) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

from . import slicers

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


def _correlate_tm(soft_re: torch.Tensor, soft_im: torch.Tensor, uw_pts,
                  u: int):
    """Correlation of (S, C) float32 soft planes with the UW along the
    time axis: ((W, C) real, (W, C) imaginary, (W, C) normalized
    magnitude), W = S - U + 1.  The (W, C, U) windows times the UW as
    matrix-vector products; the windowed energy by cumsum difference (the
    JAX package's term, so the norm rounds as there)."""
    s, c_dim = soft_re.shape
    dev = soft_re.device
    uw_conj = np.conj(np.asarray(uw_pts, np.complex64))
    ur = torch.as_tensor(np.ascontiguousarray(uw_conj.real), device=dev)
    ui = torch.as_tensor(np.ascontiguousarray(uw_conj.imag), device=dev)
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
    return acc_r, acc_i, norm


def _peak_mask_tm(norm: torch.Tensor, threshold: float,
                  sep: int) -> torch.Tensor:
    """(W, C) local-max mask of :func:`detect_peaks` along the time axis:
    norm[t] >= threshold, > the sep-1 values before, >= the sep-1 after
    (sliding maxima over an unfolded window)."""
    w, c_dim = norm.shape
    is_peak = norm >= threshold                       # compared in float32
    if sep > 1:
        wwin = sep - 1
        pad = torch.full((wwin, c_dim), -torch.inf, dtype=norm.dtype,
                         device=norm.device)
        ext = torch.cat([pad, norm, pad])             # (W + 2*wwin, C)
        wmax = ext.unfold(0, wwin, 1).amax(dim=-1)    # max over wwin rows
        left = wmax[:w]                               # (t-wwin .. t-1)
        right = wmax[wwin + 1:wwin + 1 + w]           # (t+1 .. t+wwin)
        is_peak = is_peak & (norm > left) & (norm >= right)
    return is_peak


def correlate_uw(soft, uw_pts):
    """Sliding UW correlation over the last axis.

    Args:
      soft: (..., S) complex soft symbols (tensor or array), S >= U.
      uw_pts: (U,) complex unit UW points (see :func:`uw_points`).

    Returns:
      (corr, norm): (..., S-U+1) complex64 correlation and its scale-free
      magnitude in [0, 1], on the soft block's device.
    """
    soft = torch.as_tensor(soft)
    u = np.asarray(uw_pts).size
    s = soft.shape[-1]
    if s < u:
        raise ValueError(f"stream shorter ({s}) than the UW ({u})")
    flat = soft.reshape(-1, s).T                      # (S, C')
    acc_r, acc_i, norm = _correlate_tm(flat.real.contiguous(),
                                       flat.imag.contiguous(), uw_pts, u)
    lead = tuple(soft.shape[:-1])
    w = s - u + 1
    return (torch.complex(acc_r, acc_i).T.reshape(lead + (w,)),
            norm.T.reshape(lead + (w,)))


def resolve_rotation(corr_value, m: int):
    """Correlation-peak phase -> (k, residual): the M-fold ambiguity index
    and the leftover fine phase in (-pi/M, pi/M]."""
    return resolve_rotation_angle(np.angle(np.asarray(corr_value)), m)


def resolve_rotation_angle(phi, m: int):
    """:func:`resolve_rotation` from an already-extracted peak phase (the
    sparse detection path fetches angles, not complex phasors)."""
    phi = np.asarray(phi)
    k = np.round(phi * m / (2 * np.pi)).astype(np.int64) % m
    residual = np.angle(np.exp(1j * (phi - 2 * np.pi * k / m)))
    return k, residual.astype(np.float32)


def detect_peaks(norm: np.ndarray, threshold: float,
                 min_sep: int) -> list[np.ndarray]:
    """Local-max peak extraction (host, numpy).

    ``t`` is a peak iff norm[t] >= threshold, norm[t] strictly exceeds
    every value in the ``min_sep - 1`` positions before it, and is >= every
    value in the ``min_sep - 1`` positions after it (first-max tie-break).
    Whether t is a peak depends only on norm[t-min_sep+1 : t+min_sep], so
    streaming detection with enough lookahead is exactly one-shot
    detection (runtime/framesync relies on this).

    Returns one int64 index array per channel row.
    """
    norm = np.atleast_2d(np.asarray(norm))
    c, s = norm.shape
    if s == 0:
        return [np.zeros(0, np.int64)] * c
    k = max(int(min_sep), 1)
    pad = np.full((c, k - 1), -np.inf, norm.dtype)
    ext = np.concatenate([pad, norm, pad], axis=1)
    win = np.lib.stride_tricks.sliding_window_view(ext, 2 * k - 1, axis=1)
    left = win[:, :, :k - 1].max(axis=2) if k > 1 else \
        np.full_like(norm, -np.inf)
    right = win[:, :, k:].max(axis=2) if k > 1 else \
        np.full_like(norm, -np.inf)
    is_peak = (norm >= threshold) & (norm > left) & (norm >= right)
    return [np.flatnonzero(is_peak[i]).astype(np.int64) for i in range(c)]


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
    w = s - u + 1
    acc_r, acc_i, norm = _correlate_tm(soft_re, soft_im, fmt.points, u)
    is_peak = _peak_mask_tm(norm, fmt.threshold, max(int(fmt.separation), 1))

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


# -- the streaming path: sparse detection and head extraction ----------------

class SparseCandidates(typing.NamedTuple):
    """Host-fetched sparse detection table, (channel, t) row-major.
    ``idx`` keeps positions integer-exact at any block length."""

    idx: np.ndarray    # (N, 2) int32 [channel, t]
    vals: np.ndarray   # (N, 2) float32 [norm, angle]


def _no_candidates() -> SparseCandidates:
    return SparseCandidates(np.zeros((0, 2), np.int32),
                            np.zeros((0, 2), np.float32))


def detect_uw_sparse(soft, fmt: FrameFormat,
                     kmax: int | None = None) -> SparseCandidates:
    """UW detection on the soft block's device, fetching only the
    candidates.

    Args:
      soft: (C, S) complex soft plane (a tensor stays on its device; an
        array runs on the CPU).
      fmt: frame format (the :func:`detect_peaks` threshold/separation
        rule).
      kmax: candidate capacity, checked (default: the densest legal
        packing, one frame every ``separation`` positions on every
        channel); more peaks than that raise.

    Returns:
      :class:`SparseCandidates` in (channel, t) row-major order.  The
      ``torch.nonzero`` of the peak mask is the one sync; the fetch is 16
      bytes per candidate.
    """
    soft = torch.as_tensor(soft)
    c, s = soft.shape
    u = fmt.uw_len
    if s < u:
        return _no_candidates()
    w = s - u + 1
    if kmax is None:
        kmax = c * (w // fmt.separation + 1)
    kmax = max(int(kmax), 1)
    acc_r, acc_i, norm = _correlate_tm(soft.real.T.contiguous(),
                                       soft.imag.T.contiguous(), fmt.points,
                                       u)
    is_peak = _peak_mask_tm(norm, fmt.threshold, max(int(fmt.separation), 1))
    nz = torch.nonzero(is_peak.T)                     # (N, 2) [c, t]
    n = nz.shape[0]
    if n == 0:
        return _no_candidates()
    if n > kmax:
        raise RuntimeError(f"{n} peaks exceed candidate capacity {kmax}")
    ci, ti = nz[:, 0], nz[:, 1]
    vals = torch.stack([norm[ti, ci],
                        torch.atan2(acc_i[ti, ci], acc_r[ti, ci])], dim=1)
    # One fetch: the float pair rides as its int32 bit pattern.
    table = torch.cat([nz.to(torch.int32), vals.view(torch.int32)],
                      dim=1).cpu().numpy()
    return SparseCandidates(np.ascontiguousarray(table[:, :2]),
                            np.ascontiguousarray(table[:, 2:]).view(
                                np.float32))


def extract_heads(soft, fmt: FrameFormat, heads_c, heads_t, ks):
    """Payload derotation and re-slice for N committed frame heads: one
    gather of their payload rows on the soft block's device, derotated by
    exp(-j*2pi*k/M) and sliced; fetches exactly the N rows.

    Returns (soft (N, payload) complex64, bits (N, payload*nb) int8) as
    numpy.
    """
    soft = torch.as_tensor(soft)
    n = len(heads_c)
    nb = int(np.log2(fmt.m))
    if n == 0:
        return (np.zeros((0, fmt.payload), np.complex64),
                np.zeros((0, fmt.payload * nb), np.int8))
    dev = soft.device
    ci = torch.as_tensor(np.asarray(heads_c, np.int64), device=dev)
    ti = torch.as_tensor(np.asarray(heads_t, np.int64), device=dev)
    kk = torch.as_tensor(np.asarray(ks, np.int32), device=dev)
    cols = ti[:, None] + fmt.uw_len + torch.arange(fmt.payload, device=dev)
    pm = soft[ci[:, None], cols]                      # (N, payload)
    ang = (-2.0 * np.pi / fmt.m) * kk.to(torch.float32)
    pm = pm * torch.complex(torch.cos(ang), torch.sin(ang))[:, None]
    bits = slicers.slice_bits(fmt.m, pm)[..., :nb].reshape(n, -1)
    return pm.cpu().numpy(), bits.to(torch.int8).cpu().numpy()


def extract_frames(fmt: FrameFormat, soft, base: int = 0) -> list[Frame]:
    """One-shot frame extraction from a (C, S) soft block (host helper).

    Only frames fully contained in the block are returned; for streaming
    use runtime/framesync.FrameSyncer, which carries the seam.
    """
    if isinstance(soft, torch.Tensor):
        soft = soft.cpu().numpy()
    soft = np.atleast_2d(np.asarray(soft, np.complex64))
    if soft.shape[-1] < fmt.frame_len:
        return []
    corr, norm = (t.numpy() for t in correlate_uw(torch.from_numpy(soft),
                                                  fmt.points))
    # Detect on the whole norm (local-max context), then keep the starts
    # whose payload is contained: streaming equals one-shot.
    scan = soft.shape[-1] - fmt.frame_len + 1
    peaks = [ts[ts < scan] for ts in
             detect_peaks(norm, fmt.threshold, fmt.separation)]
    heads = [(c, int(t)) for c, ts in enumerate(peaks) for t in ts]
    if not heads:
        return []
    nb = int(np.log2(fmt.m))
    ks, ress, payloads = [], [], []
    for c, t in heads:
        k, res = resolve_rotation(corr[c, t], fmt.m)
        derot = np.exp(-2j * np.pi * int(k) / fmt.m).astype(np.complex64)
        ks.append(int(k))
        ress.append(float(res))
        payloads.append(soft[c, t + fmt.uw_len: t + fmt.frame_len] * derot)
    pm = np.asarray(payloads, np.complex64).reshape(len(heads), fmt.payload)
    bits = slicers.slice_bits(fmt.m, torch.from_numpy(pm))[..., :nb]
    bits = bits.reshape(len(heads), -1).to(torch.int8).numpy()
    return [Frame(channel=c, start=base + t, rotation=ks[i],
                  corr=float(norm[c, t]), residual_phase=ress[i],
                  soft=pm[i], bits=bits[i])
            for i, (c, t) in enumerate(heads)]
