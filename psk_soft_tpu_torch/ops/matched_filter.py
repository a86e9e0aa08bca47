"""Front-end matched filtering: boxcar and root-raised-cosine
(port of ``psk_soft_tpu/ops/matched_filter.py:24-101``).

Plain torch; only the feed-forward warm-up runs it.  The FIR is unfold +
matmul with the taps, exact float32 on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DemodConfig


def rrc_taps(sps: int, beta: float = 0.35, span: int = 8,
             dtype=np.float32) -> np.ndarray:
    """Root-raised-cosine taps, unit energy, length span*sps + 1."""
    if not 0 < beta <= 1:
        raise ValueError(f"beta must be in (0, 1], got {beta}")
    n = span * sps
    t = (np.arange(n + 1, dtype=np.float64) - n / 2.0) / sps
    taps = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            taps[i] = 1.0 - beta + 4 * beta / np.pi
        elif beta > 0 and abs(abs(ti) - 1.0 / (4 * beta)) < 1e-9:
            taps[i] = (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * ti * (1 - beta))
                   + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            taps[i] = num / den
    taps /= np.sqrt(np.sum(taps ** 2))
    return taps.astype(dtype)


def boxcar_taps(sps: int, dtype=np.float32) -> np.ndarray:
    """Integrate-and-dump filter matched to rectangular pulses."""
    return (np.ones(sps) / sps).astype(dtype)


def filter_taps(cfg: DemodConfig) -> np.ndarray | None:
    if cfg.matched_filter == "none":
        return None
    if cfg.matched_filter == "boxcar":
        return boxcar_taps(cfg.sps)
    return rrc_taps(cfg.sps, cfg.rrc_beta, cfg.rrc_span)


def apply_fir(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Complex FIR, 'valid' alignment: y[t] = sum_k taps[k] x[t+k], with x
    already including the (ntaps-1)-sample left tail.

    x: (..., T + ntaps - 1) complex; returns (..., T) complex.
    """
    n = taps.shape[-1]
    re = x.real.unfold(-1, n, 1) @ taps
    im = x.imag.unfold(-1, n, 1) @ taps
    return torch.complex(re, im)


def streaming_filter(x: torch.Tensor, tail: torch.Tensor, taps: torch.Tensor):
    """Overlap-save streaming FIR: returns (y (..., T), new_tail)."""
    xt = torch.cat([tail, x], dim=-1)
    y = apply_fir(xt, taps)
    ntaps = taps.shape[-1]
    new_tail = xt[..., xt.shape[-1] - (ntaps - 1):] if ntaps > 1 else tail
    return y, new_tail
