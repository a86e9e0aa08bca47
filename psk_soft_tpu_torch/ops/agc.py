"""Automatic gain control + squelch front end, block form
(port of ``psk_soft_tpu/ops/agc.py:53-209``).

The classical AGC is a per-sample recursion ``p[n] = (1-a) p[n-1] +
a |x[n]|^2``, ``g[n] = target / sqrt(p[n])``.  Two recasts make it block
parallel: the envelope updates once per ``chunk`` samples from chunk-mean
powers, and over a block of K chunk powers q the EMA is the closed form

    p[k] = (1-a)^(k+1) * p0  +  sum_j a (1-a)^(k-j) q[j]

one (K, K) lower-triangular float32 matrix product (``torch.matmul``,
full float32: TF32 stays off) plus a decay vector times the carried
power.  Squelch: chunks whose tracked power is below ``squelch_power``
output zeros while the EMA keeps tracking.  The state is one power per
channel plus a primed flag (the first chunk initialises the power from the
data).  Streaming over any block split equals one-shot processing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AgcConfig:
    """AGC/squelch configuration (the JAX package's fields).

    Attributes:
      target_rms: output RMS the gain drives toward.
      alpha: per-chunk EMA weight (time constant ``chunk / alpha`` samples).
      chunk: samples per gain update (pair it with the demod's sps).
      squelch_power: mean-square power threshold; chunks tracking below it
        are muted (0.0 disables squelch).
      eps: floor inside the inverse square root.
    """

    target_rms: float = 1.0
    alpha: float = 0.05
    chunk: int = 8
    squelch_power: float = 0.0
    eps: float = 1e-12

    def __post_init__(self):
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1]; got {self.alpha}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1; got {self.chunk}")


class AgcState(NamedTuple):
    power: torch.Tensor   # (...,) carried EMA of chunk-mean |x|^2
    primed: torch.Tensor  # (...,) bool: power holds real data


def agc_init(cfg: AgcConfig, channel_shape, device) -> AgcState:
    """Fresh state for ``channel_shape`` channels (a tuple or an int) on
    ``device``."""
    shape = (channel_shape,) if isinstance(channel_shape, int) \
        else tuple(channel_shape)
    return AgcState(power=torch.ones(shape, dtype=torch.float32,
                                     device=device),
                    primed=torch.zeros(shape, dtype=torch.bool,
                                       device=device))


@functools.lru_cache(maxsize=64)
def _ema_mats_np(alpha: float, k: int):
    """Lower-triangular exponential-weight matrix L (K, K) and decay d (K,)
    with p = L @ q + d * p0, as float32 numpy."""
    j = np.arange(k)
    expo = j[:, None] - j[None, :]
    lower = alpha * (1.0 - alpha) ** np.maximum(expo, 0) * (expo >= 0)
    d = (1.0 - alpha) ** (j + 1)
    return lower.astype(np.float32), d.astype(np.float32)


def _ema_mats(alpha: float, k: int, device):
    lower, d = _ema_mats_np(alpha, k)
    return (torch.from_numpy(lower).to(device),
            torch.from_numpy(d).to(device))


def _gain(cfg: AgcConfig, p: torch.Tensor):
    gain = cfg.target_rms / torch.sqrt(torch.clamp(p, min=cfg.eps))
    if cfg.squelch_power > 0.0:
        active = p >= cfg.squelch_power
    else:
        active = torch.ones_like(p, dtype=torch.bool)
    return torch.where(active, gain, torch.zeros_like(gain)), active


def agc_block(cfg: AgcConfig, state: AgcState, x: torch.Tensor):
    """AGC over a channel-major block.

    Args:
      state: per-channel carry; shapes broadcast from ``x.shape[:-1]``.
      x: (..., T) complex64 with T a multiple of ``cfg.chunk``.
    Returns (new_state, y, info): y the gained (and squelched) block, info
    the per-chunk ``gain``, tracked ``power`` and squelch ``active``
    (..., K).
    """
    t = x.shape[-1]
    if t % cfg.chunk:
        raise ValueError(f"block length {t} not a multiple of "
                         f"chunk {cfg.chunk}")
    k = t // cfg.chunk
    lead = tuple(x.shape[:-1])
    pwr = x.real * x.real + x.imag * x.imag
    q = pwr.reshape(lead + (k, cfg.chunk)).mean(-1).to(torch.float32)
    p0 = torch.where(state.primed, state.power, q[..., 0])
    lower, d = _ema_mats(cfg.alpha, k, x.device)
    p = torch.einsum("kj,...j->...k", lower, q) + d * p0[..., None]
    # An unprimed stream's first chunk is exactly its own mean power.
    p[..., 0] = torch.where(state.primed, p[..., 0], q[..., 0])
    gain, active = _gain(cfg, p)
    y = (x.reshape(lead + (k, cfg.chunk))
         * gain[..., None]).reshape(x.shape).to(x.dtype)
    new_state = AgcState(power=p[..., -1],
                         primed=torch.ones_like(state.primed))
    return new_state, y, dict(gain=gain, power=p, active=active)


def agc_block_tm(cfg: AgcConfig, state: AgcState, x_re: torch.Tensor,
                 x_im: torch.Tensor):
    """:func:`agc_block` on time-major (T, C) float32 planes, the demod
    kernel's layout, so the AGC runs ahead of it with no relayout
    (models/chain.make_front_chain_fn).  The EMA is ``L @ q`` over the
    (K, C) chunk-power plane.

    Returns (new_state, y_re, y_im, info); state shapes are (C,).
    """
    t, c = x_re.shape
    if t % cfg.chunk:
        raise ValueError(f"block length {t} not a multiple of "
                         f"chunk {cfg.chunk}")
    k = t // cfg.chunk
    pwr = x_re * x_re + x_im * x_im
    q = pwr.reshape(k, cfg.chunk, c).mean(1).to(torch.float32)
    p0 = torch.where(state.primed, state.power, q[0])
    lower, d = _ema_mats(cfg.alpha, k, x_re.device)
    p = lower @ q + d[:, None] * p0[None, :]
    p[0] = torch.where(state.primed, p[0], q[0])
    gain, active = _gain(cfg, p)                          # (K, C)
    g_t = torch.repeat_interleave(gain, cfg.chunk, dim=0)  # (T, C)
    new_state = AgcState(power=p[-1], primed=torch.ones_like(state.primed))
    return (new_state, (x_re * g_t).to(x_re.dtype),
            (x_im * g_t).to(x_im.dtype),
            dict(gain=gain, power=p, active=active))


def make_agc_fn(cfg: AgcConfig):
    """fn(state, x) -> (state, y, info) over any leading channel axes."""
    return functools.partial(agc_block, cfg)


def agc_reference(cfg: AgcConfig, x: np.ndarray, p0: float | None = None):
    """Sequential chunk-recurrence oracle (numpy, float64) for tests."""
    t = x.size
    k = t // cfg.chunk
    q = np.mean(np.abs(x.reshape(k, cfg.chunk)) ** 2, axis=-1)
    p = np.empty(k, np.float64)
    prev = q[0] if p0 is None else p0
    for i in range(k):
        if i == 0 and p0 is None:
            p[0] = q[0]
        else:
            p[i] = (1.0 - cfg.alpha) * prev + cfg.alpha * q[i]
        prev = p[i]
    gain = cfg.target_rms / np.sqrt(np.maximum(p, cfg.eps))
    if cfg.squelch_power > 0.0:
        gain = np.where(p >= cfg.squelch_power, gain, 0.0)
    y = (x.reshape(k, cfg.chunk) * gain[:, None]).reshape(x.shape)
    return y.astype(np.complex64), gain, p
