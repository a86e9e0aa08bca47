"""Carrier-phase recovery primitives: M-th-power phase and unwrapping
(port of ``psk_soft_tpu/ops/phase.py:18-180``).

Per selected symbol, ``arg(sample^M)`` removes the PSK modulation; the phase
is unwrapped, fed to the sliding linear fit, and the correction applied is
``-estimate/M`` (+pi/4 for QPSK).  At block end the estimator history is
re-wrapped about ``M*2pi`` to keep it bounded (reference
``cpp/psk_soft.cpp:592-603``).

All functions work on the last axis and broadcast over leading (channel)
axes.  ``torch.round`` rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TWO_PI = 2.0 * math.pi

# Trend window for the robust unwrap (see psk_soft_tpu/ops/phase.py).
UNWRAP_TREND_LEN = 9

# Trend decimation: one trend reference per D symbols (feed-forward path).
UNWRAP_TREND_STRIDE = 4


def mth_power_phase(sample: torch.Tensor, m: int) -> torch.Tensor:
    """arg(sample**m) for power-of-two m (2..32) via repeated squaring."""
    if m < 2 or (m & (m - 1)) != 0:
        raise ValueError(f"unsupported constellation size {m}")
    s = sample
    k = m
    while k > 1:
        s = s * s
        k >>= 1
    return torch.atan2(s.imag, s.real).to(torch.float32)


def mth_power_phase_dynamic(sample: torch.Tensor,
                            m: torch.Tensor) -> torch.Tensor:
    """arg(sample**m) with a per-element m in {2, 4, 8, 16, 32} (any other
    value takes the 32nd power), by the same squarings as
    :func:`mth_power_phase`; ``m`` broadcasts against ``sample``."""
    s = sample * sample
    pick = s
    for k in (4, 8, 16):
        s = s * s
        pick = torch.where(m == k, s, pick)
    s = s * s
    known = (m == 2) | (m == 4) | (m == 8) | (m == 16)
    pick = torch.where(known, pick, s)
    return torch.atan2(pick.imag, pick.real).to(torch.float32)


def unwrap_step(prev_estimate: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """One reference unwrap (cpp/psk_soft.cpp:477-478): shift ``raw`` by
    whole turns toward the estimate.  Half-turn ties round to even, as
    ``jnp.round`` does."""
    wraps = torch.round((prev_estimate - raw) / TWO_PI)
    return raw + wraps * TWO_PI


def block_unwrap(raw: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Prefix unwrap of ``raw`` (last axis) against the carried ``prev``:
    each element moves by whole turns so successive differences lie in
    (-pi, pi]; cumulative wrap counts are a prefix sum."""
    cat = torch.cat([prev.unsqueeze(-1), raw], dim=-1)
    d = cat[..., 1:] - cat[..., :-1]
    adj = torch.cumsum(torch.round(d / TWO_PI), dim=-1)
    return raw - adj * TWO_PI


def wrap_to_pi(x: torch.Tensor) -> torch.Tensor:
    """Map angles to (-pi, pi]."""
    return x - TWO_PI * torch.round(x / TWO_PI)


def causal_complex_ma(phases: torch.Tensor, k: int, stride: int = 1,
                      pad_left: int | None = None) -> torch.Tensor:
    """Causal moving average of exp(i*phase) over the last k entries,
    optionally strided (one output per ``stride`` inputs, anchored at each
    group's last element).  Head entries average over what is available
    (zero padding).  Returns the trend *angle* (..., T // stride).

    Sliding sums are unfold + sum: exact float32 on every device (a conv1d
    on CUDA would run in TF32 by default)."""
    lpad = k - stride if pad_left is None else pad_left

    def ma(v):
        v = F.pad(v, (lpad, 0))
        return v.unfold(-1, k, stride).sum(-1)

    return torch.atan2(ma(torch.sin(phases)), ma(torch.cos(phases)))


def robust_block_unwrap(raw: torch.Tensor, k: int = UNWRAP_TREND_LEN,
                        stride: int = UNWRAP_TREND_STRIDE) -> torch.Tensor:
    """Feed-forward unwrap (last axis) robust to per-symbol phase noise:

        u[t] = unwrap(trend)[g(t)] + wrap_to_pi(raw[t] - trend[g(t)])

    where the trend is a causal complex moving average decimated by
    ``stride`` and g(t) is t's trend group.  u[t] == raw[t] (mod 2pi).
    """
    t = raw.shape[-1]
    pad = (-t) % stride
    if pad:
        head = raw[..., :1].expand(*raw.shape[:-1], pad)
        rawp = torch.cat([head, raw], dim=-1)
    else:
        rawp = raw
    ang_dec = causal_complex_ma(rawp, k, stride=stride)          # (..., G)
    unwrapped_dec = block_unwrap(ang_dec, ang_dec[..., 0])
    full = lambda v: torch.repeat_interleave(v, stride, dim=-1)  # noqa: E731
    u = full(unwrapped_dec) + wrap_to_pi(rawp - full(ang_dec))
    return u[..., pad:]


def rewrap_offset(estimate: torch.Tensor, m: int) -> torch.Tensor:
    """End-of-block re-wrap offset about M*2pi: the constant to subtract
    from the estimator history (0 if the estimate is within +-M*2pi)."""
    wrap_value = TWO_PI * m
    wraps = torch.round(estimate / wrap_value)
    return torch.where(estimate.abs() > wrap_value, wraps * wrap_value,
                       torch.zeros_like(estimate))
