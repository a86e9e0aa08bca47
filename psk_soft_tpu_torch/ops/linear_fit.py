"""Sliding-window least-squares line fit evaluated at the newest point
(port of ``psk_soft_tpu/ops/linear_fit.py:39-127``).

The reference's ``LinearFit`` (``cpp/psk_soft.cpp:35-185``) fits a line to
the last ``n`` uniformly spaced points and evaluates it at the newest one.
The windowed sums are computed directly each step (no drift, no resync
counter), in units of ``xdelta = 1`` (the fit value does not depend on it).
Closed forms, with x_i = i for i in [0, p):

  m    = (xySum - (p-1)/2 * ySum) / D(p)
  fit  = ySum/p + m*(p-1)/2,        D(p) = p*(p^2-1)/12

In steady state the fit is a linear function of the window, i.e. an FIR
filter:

  w[i] = 1/n + 6*(2i - (n-1)) / (n*(n+1)),  i = 0 (oldest) .. n-1 (newest).
"""

from __future__ import annotations

import numpy as np
import torch


def denominator(pts: torch.Tensor) -> torch.Tensor:
    """D(p) = p(p^2-1)/12 in units of xdelta=1 (cpp/psk_soft.cpp:176-185)."""
    p = pts.to(torch.float32)
    return p * (p * p - 1.0) / 12.0


def fit_at_newest(ysum: torch.Tensor, xysum: torch.Tensor, pts: torch.Tensor,
                  newest: torch.Tensor) -> torch.Tensor:
    """The window fit at the newest point (cpp/psk_soft.cpp:135-174): the
    newest value itself when p == 1, 0 when p == 0.  ``xysum`` sums i * y_i
    with i the 0-based position in the window; arguments broadcast."""
    p = pts.to(torch.float32)
    d = denominator(pts)
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    m = (xysum - (p - 1.0) / 2.0 * ysum) / safe_d
    safe_p = torch.where(p == 0, torch.ones_like(p), p)
    fit = ysum / safe_p + m * (p - 1.0) / 2.0
    fit = torch.where(pts > 1, fit, newest)
    return torch.where(pts == 0, torch.zeros_like(fit), fit)


def ring_rank(n: int, pos: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """Chronological rank of each ring slot (0 = oldest): slots are written
    at ``pos`` (then pos advances mod n) and ``fill`` saturates at n, so
    once full the oldest slot is ``pos``.  pos/fill broadcast against
    ``arange(n)``."""
    idx = torch.arange(n, dtype=torch.int32, device=pos.device)
    start = torch.where(fill == n, pos, torch.zeros_like(pos))
    return torch.remainder(idx - start, n)


def ring_fit(ring: torch.Tensor, pos: torch.Tensor, fill: torch.Tensor,
             newest: torch.Tensor) -> torch.Tensor:
    """Fit-at-newest from a ring buffer (direct windowed sums).

    ring: (..., n) slots; pos: (...,) next write slot (the oldest value
    when full); fill: (...,) valid slots, saturating at n; newest: (...,)
    the value written last (returned for fill <= 1)."""
    n = ring.shape[-1]
    rank = ring_rank(n, pos.unsqueeze(-1), fill.unsqueeze(-1))
    maskv = (rank < fill.unsqueeze(-1)).to(ring.dtype)
    ysum = torch.sum(ring * maskv, dim=-1)
    xysum = torch.sum(rank.to(ring.dtype) * ring * maskv, dim=-1)
    return fit_at_newest(ysum, xysum, fill, newest)


def endpoint_fir_weights(n: int, dtype=np.float32) -> np.ndarray:
    """Steady-state FIR weights w with fit = sum_i w[i] * y[window_i].

    Derivation: fit = ybar + m*(n-1)/2, m = sum_i (i - (n-1)/2) y_i / D(n),
    D(n) = n(n^2-1)/12.
    """
    if n == 1:
        return np.ones((1,), dtype=dtype)
    i = np.arange(n, dtype=np.float64)
    w = 1.0 / n + (i - (n - 1) / 2.0) * ((n - 1) / 2.0) / (n * (n * n - 1) / 12.0)
    return w.astype(dtype)


def warmup_fir_weight_matrix(n: int, dtype=np.float32) -> np.ndarray:
    """(n, n) matrix whose row p-1 holds the length-p fit weights, right-aligned.

    Row p-1, columns n-p .. n-1 contain the endpoint weights for a window of
    length p (columns before that are zero): the growing window of the
    tracker's warm-up.
    """
    out = np.zeros((n, n), dtype=np.float64)
    for p in range(1, n + 1):
        out[p - 1, n - p:] = endpoint_fir_weights(p, dtype=np.float64)
    return out.astype(dtype)
