"""Polyphase DFT analysis channelizer, the wideband front end (port of
``psk_soft_tpu/ops/channelizer.py:42-172``).

Every deployment of the reference runs downstream of a channelizer: the
component demodulates ONE narrowband stream (cpp/psk_soft.cpp
serviceFunction), and a wideband capture is split into C such streams by an
upstream filterbank.  This module supplies that step on the engine's
device.

A critically-sampled weighted-overlap-add (WOLA) DFT bank: the block of
B*C wideband samples is viewed as (B, C) branch rows, the K-tap polyphase
branches reduce over K stacked row shifts (one multiply-add pass a tap),
and the branch axis is closed with one batched C-point FFT
(``torch.fft.fft``: pocketfft on the CPU, cuFFT on the card).  The carry
between blocks is the last K-1 branch rows, so streaming is block-split
invariant by construction.

Conventions (pinned by the tests against a direct per-channel DDC oracle):

* channel ``m`` is the band centered at ``+m/C`` of the wideband sample
  rate (m > C/2 aliases to negative frequencies, FFT order);
* output rate is ``fs / C`` (critically sampled);
* alignment is block-anticausal: output row t of the block reads wideband
  samples ``tC .. tC + K*C - 1`` of (carry ++ block).
"""

from __future__ import annotations

import numpy as np
import torch


def prototype_taps(channels: int, taps_per_branch: int = 8,
                   beta: float = 9.0, cutoff_scale: float = 1.0,
                   dtype=np.float32) -> np.ndarray:
    """Kaiser-windowed-sinc prototype lowpass, length K*C (numpy, bit-equal
    to the JAX package's).

    Cutoff is ``cutoff_scale / (2C)`` of the wideband rate (the critical
    per-channel Nyquist edge; < 1 trades edge droop for alias rejection;
    > 1 only makes sense for the oversampled-by-2 bank).  Normalized to
    unit passband gain through the bank (a tone at a channel center comes
    out at amplitude 1).
    """
    if channels < 2:
        raise ValueError(f"channels must be >= 2, got {channels}")
    if taps_per_branch < 2:
        raise ValueError(f"taps_per_branch must be >= 2, "
                         f"got {taps_per_branch}")
    if not 0 < cutoff_scale <= 2:
        raise ValueError(f"cutoff_scale must be in (0, 2], "
                         f"got {cutoff_scale}")
    L = channels * taps_per_branch
    n = np.arange(L, dtype=np.float64) - (L - 1) / 2
    h = (cutoff_scale / channels) * np.sinc(cutoff_scale * n / channels)
    x = np.clip(n / ((L - 1) / 2), -1.0, 1.0)
    h *= np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
    return (h / h.sum()).astype(dtype)


def channelizer_init(channels: int, taps_per_branch: int,
                     device="cuda") -> torch.Tensor:
    """Fresh carry: K-1 zero branch rows of (C,) complex64 on ``device``."""
    return torch.zeros((taps_per_branch - 1, channels), dtype=torch.complex64,
                       device=device)


def _branch_sum(hpoly: torch.Tensor, z: torch.Tensor, rows: int,
                step: int, start: int) -> torch.Tensor:
    """sum_k hpoly[k] * z[start + step*k : start + step*k + rows], one
    multiply-add pass a tap in tap order (the JAX chain's order)."""
    v = hpoly[0] * z[start:start + rows]
    for k in range(1, hpoly.shape[0]):
        s = start + step * k
        v.addcmul_(hpoly[k], z[s:s + rows])
    return v


def channelize_block(taps: torch.Tensor, carry: torch.Tensor,
                     x: torch.Tensor):
    """One streaming analysis step, on the carry's device.

    Args:
      taps: (K*C,) float32 prototype (``prototype_taps``).
      carry: (K-1, C) complex64 branch-row history (``channelizer_init``).
      x: (B*C,) complex64 wideband block, B >= 1.

    Returns:
      (new_carry, y) with y (B, C) complex64: y[t, m] is channel m's
      baseband sample t at rate fs/C.  Oracle identity (tests):
      ``y[t, m] == sum_l h[l] * xx[t*C + l] * exp(-2j*pi*m*l/C)`` where
      xx = concat(carry_samples, x).
    """
    C = carry.shape[1]
    K = carry.shape[0] + 1
    if x.ndim != 1 or x.shape[0] % C:
        raise ValueError(f"block length must be a multiple of C={C}, "
                         f"got shape {tuple(x.shape)}")
    B = x.shape[0] // C
    z = torch.cat([carry, x.reshape(B, C)])                # (B+K-1, C)
    hpoly = taps.reshape(K, C).to(torch.complex64)
    v = _branch_sum(hpoly, z, B, 1, 0)
    y = torch.fft.fft(v, dim=-1)
    return z[B:], y


def channelizer_os2_init(channels: int, taps_per_branch: int,
                         device="cuda") -> torch.Tensor:
    """Fresh carry for the 2x-oversampled bank: 2K-1 zero half-rows of
    (C/2,) complex64 on ``device``."""
    if channels % 2:
        raise ValueError("oversampled-by-2 bank needs even channels")
    return torch.zeros((2 * taps_per_branch - 1, channels // 2),
                       dtype=torch.complex64, device=device)


def channelize_block_os2(taps: torch.Tensor, carry: torch.Tensor,
                         x: torch.Tensor):
    """2x-oversampled analysis step: hop C/2 instead of C.

    Halving the hop doubles each channel's output rate to 2fs/C, so the
    band survives up to its edge, at the cost of the decimation no longer
    cancelling the t-dependent twiddle: odd output rows pick up
    e^{-j pi m} = (-1)^m (one sign plane).

    Args/returns as :func:`channelize_block`, except carry is (2K-1, C/2)
    (``channelizer_os2_init``) and y has 2B rows per B*C-sample block.
    Oracle identity (tests): ``y[t, m] == sum_l h[l] * xx[t*C/2 + l] *
    exp(-2j*pi*m*(t*C/2 + l)/C)`` with xx = concat(carry_samples, x).
    """
    R = carry.shape[1]                        # C/2
    C = 2 * R
    K = (carry.shape[0] + 1) // 2
    if x.ndim != 1 or x.shape[0] % C:
        raise ValueError(f"block length must be a multiple of C={C}, "
                         f"got shape {tuple(x.shape)}")
    B = 2 * (x.shape[0] // C)                 # output rows (even per block)
    u = torch.cat([carry, x.reshape(B, R)])   # (B+2K-1, R)
    hpoly = taps.reshape(K, C).to(torch.complex64)
    # branch p < R reads u[t + 2k, p]; branch p >= R reads u[t + 2k + 1,
    # p - R]: two half-width shift chains, concatenated on the branch axis.
    lo = _branch_sum(hpoly[:, :R], u, B, 2, 0)
    hi = _branch_sum(hpoly[:, R:], u, B, 2, 1)
    y = torch.fft.fft(torch.cat([lo, hi], dim=1), dim=-1)
    # odd rows: e^{-j pi m t} twiddle.  B is even, so block parity never
    # leaks into the carry.
    y[1::2, 1::2] = -y[1::2, 1::2]
    return u[B:], y


def channel_frequencies(channels: int, xdelta: float) -> np.ndarray:
    """Center frequency of each output channel in Hz for an input SRI
    sample spacing ``xdelta`` (FFT bin order: m > C/2 are negative)."""
    fs = 1.0 / xdelta
    f = np.arange(channels, dtype=np.float64) * fs / channels
    f[channels // 2 + 1:] -= fs
    return f
