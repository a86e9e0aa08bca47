"""Sliding-window least-squares line fit evaluated at the newest point, as
FIR tables (numpy; port of ``psk_soft_tpu/ops/linear_fit.py:69-95``).

In steady state the fit-at-newest-point over the last ``n`` uniformly spaced
points is a linear function of the window, i.e. an FIR filter:

  w[i] = 1/n + 6*(2i - (n-1)) / (n*(n+1)),  i = 0 (oldest) .. n-1 (newest).
"""

from __future__ import annotations

import numpy as np


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
