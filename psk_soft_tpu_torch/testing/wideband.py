"""Test signals for the input side (numpy): raised-cosine PSK at any,
even fractional, samples per symbol, and a polyphase DFT synthesis bank
that sums C channel-rate streams into one wideband capture.

The synthesis bank is the inverse of ops/channelizer's analysis bank: one
inverse FFT per channel-rate row across the C channels, then a K-tap
filter per branch with the analysis prototype scaled by C, so channel m
comes out of ``channelize_block`` at bin m with unit gain.  Its cost is
O(rows * C * (log C + K)), where summing per-channel upconverted streams
is O(rows * C) per channel.
"""

from __future__ import annotations

import numpy as np


def raised_cosine(t: np.ndarray, beta: float) -> np.ndarray:
    """Raised-cosine pulse at ``t`` symbols (1 at 0, 0 at other integer
    t: no intersymbol interference at the symbol centres)."""
    t = np.asarray(t, np.float64)
    den = 1.0 - (2.0 * beta * t) ** 2
    edge = np.abs(den) < 1e-12
    safe = np.where(edge, 1.0, den)
    p = np.sinc(t) * np.cos(np.pi * beta * t) / safe
    return np.where(edge, np.pi / 4 * np.sinc(1.0 / (2.0 * beta)), p)


def rc_psk(sps, n: int, m, rng, offset: float = 0.0, beta: float = 0.35,
           span: int = 4):
    """M-PSK through a raised-cosine pulse, one row per channel.

    sps: (C,) samples per symbol of each channel (any positive reals).
    n: samples per channel.  m: the PSK order, scalar or (C,).
    offset: sample position of symbol 0's centre (symbol j sits at
      ``offset + j * sps``).  The pulse is cut at ``span`` + 1 symbols.

    Returns (x, idx): (C, n) complex64 and (C, nsym) int symbol indices
    (symbol j of channel c is exp(2j pi idx[c, j] / m + j pi / 4)).
    """
    sps = np.asarray(sps, np.float64)
    n_ch = sps.size
    m = np.broadcast_to(np.asarray(m), (n_ch,))
    lead = span + 2 + int(np.ceil(offset / sps.min()))  # before symbol 0
    nsym = int(np.ceil((n - offset) / sps.min())) + 1
    idx = rng.integers(0, m[:, None], (n_ch, lead + nsym + span + 2))
    pts = np.exp(2j * np.pi * idx / m[:, None] + 1j * np.pi / 4).astype(
        np.complex64)
    uniq, inv = np.unique(sps, return_inverse=True)
    pos = (np.arange(n, dtype=np.float64)[None, :] - offset) / uniq[:, None]
    j0 = np.floor(pos).astype(np.int64)  # (U, n): the symbol at or before
    x = np.zeros((n_ch, n), np.complex64)
    for d in range(-span, span + 2):
        j = j0 - d + 1
        p = raised_cosine(pos - j, beta).astype(np.float32)
        x += p[inv] * np.take_along_axis(pts, (j + lead)[inv], axis=1)
    return x, idx[:, lead:lead + nsym]


def synthesize(x: np.ndarray, taps: np.ndarray, carry=None):
    """Polyphase DFT synthesis of channel-rate rows into a wideband block.

    x: (rows, C) complex channel-rate samples (channel m -> band centred
      at +m/C of the wideband rate).
    taps: (K*C,) analysis prototype (ops/channelizer.prototype_taps).
    carry: (K-1, C) complex128 history of the previous call (None: zeros).

    Returns (wide, carry): (rows*C,) complex64 and the new history.
    """
    rows, n_ch = x.shape
    k = taps.size // n_ch
    v = np.fft.ifft(np.asarray(x, np.complex128), axis=1) * n_ch
    if carry is None:
        carry = np.zeros((k - 1, n_ch), np.complex128)
    z = np.concatenate([carry, v])                  # (rows + K - 1, C)
    g = taps.reshape(k, n_ch).astype(np.float64) * n_ch
    w = np.zeros((rows, n_ch), np.complex128)
    for i in range(k):
        w += g[i] * z[k - 1 - i:k - 1 - i + rows]
    return w.astype(np.complex64).ravel(), z[rows:]
