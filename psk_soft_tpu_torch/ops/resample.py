"""Per-channel arbitrary-ratio polyphase resampler, the bank front end
(port of ``psk_soft_tpu/ops/resample.py:33-188``).

The reference component processes ONE stream at its configured
samplesPerBaud (cpp/psk_soft.cpp serviceFunction); this resampler converts
every channel of a bank to the bank's common sps on the device, so one
kernel-B1 bank serves channels whose native rates differ per channel (and
even fractionally, e.g. sps 7.3).

Two device forms over time-major (T, C) planes:

* :func:`resample_block` -- a quantized-phase polyphase interpolation bank.
  Output sample n of channel c reads K input rows at ``floor(pos)`` with
  ``pos = pos0[c] + n * ratio[c]``; the K tap values come from a (P+1, K)
  windowed-sinc table indexed by the fractional part (with linear
  interpolation between adjacent phase rows).  K rounds of
  ``torch.gather`` plus multiply-adds.
* :func:`resample_block_uniform` -- one shared rational ratio num/den:
  shifted reshapes into (num+K)-row windows and one banded product with
  the exact-phase matrix of :func:`uniform_poly_matrix` per plane.

Ragged per-channel consumption bookkeeping stays on the host
(runtime/resampler.py): the device sees fixed shapes every block.
"""

from __future__ import annotations

import numpy as np
import torch


def kaiser_sinc_table(n_phases: int = 128, taps_per_phase: int = 8,
                      cutoff: float = 1.0, beta: float = 8.0,
                      dtype=np.float32) -> np.ndarray:
    """(P+1, K) polyphase interpolation table (numpy, bit-equal to the JAX
    package's).

    Row p reconstructs x(i0 + K//2 - 1 + p/P) from input rows
    i0 .. i0+K-1: ``table[p, k] = c*sinc(c*(K//2 - 1 + p/P - k)) * w_k``
    with a Kaiser window centered on the interpolation point.  cutoff < 1
    (relative to input Nyquist) widens the anti-alias margin for
    downsampling ratios > 1.
    """
    if not 0 < cutoff <= 1:
        raise ValueError(f"cutoff must be in (0, 1], got {cutoff}")
    P, K = n_phases, taps_per_phase
    k = np.arange(K, dtype=np.float64)
    # include phase row P (== next integer sample, phase 0) so linear
    # interpolation between rows p and p+1 never wraps
    u = np.arange(P + 1, dtype=np.float64)[:, None] / P
    t = K // 2 - 1 + u - k[None, :]          # signed distance to tap k
    h = cutoff * np.sinc(cutoff * t)
    # Kaiser window evaluated at the same offsets, half-width K/2
    x = np.clip(t / (K / 2), -1.0, 1.0)
    w = np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
    h = h * w
    # unit DC gain per phase row (flat passband through the interpolator)
    h /= h.sum(axis=1, keepdims=True)
    return h.astype(dtype)


def resample_block(x_re: torch.Tensor, x_im: torch.Tensor,
                   pos0: torch.Tensor, ratio: torch.Tensor,
                   table: torch.Tensor, n_out: int):
    """Resample (T_in, C) float32 planes to (n_out, C) at per-channel
    ratios, on the planes' device.

    pos0: (C,) float32 -- absolute position (input rows, fractional) of
      output sample 0 per channel.  The caller guarantees every read stays
      in bounds: K//2 - 1 <= pos < T_in - K//2 for all n < n_out (the
      streaming wrapper sizes its window so this holds; indices are clamped
      as a belt-and-braces guard, never as semantics).
    ratio: (C,) float32 -- input samples per output sample (in/out rate).
    table: (P+1, K) from :func:`kaiser_sinc_table`.

    Returns (y_re, y_im, pos_end) with pos_end = pos0 + n_out*ratio, the
    carry for the next block.
    """
    T_in = x_re.shape[0]
    P = table.shape[0] - 1
    K = table.shape[1]
    # float32 positions rounded once from pos0 + n*ratio, as a fused
    # multiply-add gives them (XLA contracts JAX's expression so on the
    # CPU); the float64 product is exact, so the card and the CPU agree.
    n = torch.arange(n_out, dtype=torch.float64,
                     device=x_re.device)[:, None]              # (n_out, 1)
    pos = (pos0.double()[None, :] + n * ratio.double()[None, :]).float()
    base = torch.floor(pos)
    frac = pos - base                                           # [0, 1)
    i0 = base.to(torch.int64) - (K // 2 - 1)
    fp = frac * P
    pf = torch.floor(fp)
    p = pf.to(torch.int64)                                      # 0..P-1
    a = fp - pf                                                 # lerp weight

    y_re = torch.zeros(pos.shape, dtype=x_re.dtype, device=x_re.device)
    y_im = torch.zeros_like(y_re)
    for k in range(K):
        col = table[:, k]
        tap = (1.0 - a) * col[p] + a * col[p + 1]               # (n_out, C)
        idx = (i0 + k).clamp(0, T_in - 1)
        y_re = y_re + tap * torch.gather(x_re, 0, idx)
        y_im = y_im + tap * torch.gather(x_im, 0, idx)
    pos_end = (pos0.double() + n_out * ratio.double()).float()
    return y_re, y_im, pos_end


def resample_positions_valid(pos0: np.ndarray, ratio: np.ndarray,
                             n_out: int, t_in: int, taps_per_phase: int
                             ) -> bool:
    """Host-side check of the in-bounds contract documented on
    :func:`resample_block`."""
    K = taps_per_phase
    last = pos0 + (n_out - 1) * ratio
    return bool(np.all(pos0 >= K // 2 - 1) and np.all(last < t_in - K // 2))


def uniform_poly_matrix(num: int, den: int, taps_per_phase: int = 8,
                        cutoff: float = 1.0, beta: float = 8.0,
                        dtype=np.float32) -> np.ndarray:
    """Banded polyphase selection matrix for a UNIFORM rational ratio
    num/den (input samples per output sample; numpy, bit-equal to the JAX
    package's).

    Row j holds the taps that produce output phase j of a den-output cycle
    from the cycle's (num + K)-row input window:
    ``y[q*den + j] = sum_t S[j, t] * x[q*num + t]`` with the exact
    fractional phases (no table quantization, unlike the gather path).
    """
    if num <= 0 or den <= 0:
        raise ValueError("num/den must be positive")
    K = taps_per_phase
    p0 = K // 2 - 1          # same start contract as resample_block
    S = np.zeros((den, num + K), np.float64)
    for j in range(den):
        pos = p0 + j * num / den
        base = int(np.floor(pos))
        u = pos - base
        i0 = base - (K // 2 - 1)
        k = np.arange(K, dtype=np.float64)
        t = K // 2 - 1 + u - k
        h = cutoff * np.sinc(cutoff * t)
        x = np.clip(t / (K / 2), -1.0, 1.0)
        h *= np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
        h /= h.sum()
        S[j, i0: i0 + K] = h
    return S.astype(dtype)


def resample_block_uniform(x_re: torch.Tensor, x_im: torch.Tensor,
                           S: torch.Tensor, num: int, den: int):
    """Uniform-ratio resample of (T_in, C) planes: every den outputs
    consume num inputs, T_in = Q*num + K rows (Q full cycles + tap tail),
    returns (Q*den, C) planes.

    Streaming contract: output row 0 sits at input position K//2 - 1
    (same as resample_block); after the call the caller keeps the last
    T_in - Q*num input rows as the next block's head.  The rational grid
    restarts each cycle exactly, so there is NO position carry.

    The products run in float32 with TF32 off for the call (matmul
    precision "highest"), whatever the caller's setting, which is restored
    after.
    """
    K = S.shape[1] - num
    T_in = x_re.shape[0]
    Q = (T_in - K) // num
    if Q <= 0:
        raise ValueError(f"need at least num+K={num + K} rows, got {T_in}")

    # Overlapping (num+K)-row windows at stride num, built from a handful
    # of shifted reshapes (2 when num >= K).  Padded rows can only land in
    # window columns >= K of the final cycle, which the band structure of
    # S never touches.
    m_shifts = -(-(num + K) // num)
    need_rows = (m_shifts - 1) * num + Q * num
    pad = max(0, need_rows - T_in)

    def windows(x):
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
        parts = [xp[s * num: s * num + Q * num].reshape(Q, num, -1)
                 for s in range(m_shifts)]
        return torch.cat(parts, dim=1)[:, :num + K]

    C = x_re.shape[1]
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")     # no TF32 rounding
    try:
        y_re = torch.einsum("jt,qtc->qjc", S, windows(x_re))
        y_im = torch.einsum("jt,qtc->qjc", S, windows(x_im))
    finally:
        torch.set_float32_matmul_precision(precision)
    return y_re.reshape(Q * den, C), y_im.reshape(Q * den, C)
