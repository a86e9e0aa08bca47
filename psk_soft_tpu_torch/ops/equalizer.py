"""Blind adaptive channel equalizer, block CMA (port of
``psk_soft_tpu/ops/equalizer.py:66-257``).

The constant-modulus algorithm (CMA, Godard) is a per-sample recursion

    y[n] = w^H x_n ;  e[n] = y[n] (|y[n]|^2 - R2) ;  w <- w - mu e[n] x_n*

The block form freezes the weights within a block:

1. **Filtering**: an L-tap FIR with per-channel weights over the (C, T)
   block, L shifted multiply-adds, with an (L-1)-sample history carry so
   streaming over any block split equals one-shot filtering.
2. **Gradient**: g[l] = sum_k e[k] conj(x[k*stride + L-1 - l]), a
   correlation of the error against L strided slices of the input.  The
   slices are views; each correlation is one multiply and one sum, so the
   (C, L, K) stack the JAX package builds (1.1 GB a block at 1024
   channels, 33 taps, 4096 errors) never exists.  One update per block with
   the summed, power-normalised gradient (Block-LMS): keep mu * K <~ 0.25
   at unit input power.

``mode="dd"`` takes decision-directed LMS errors on rotation-invariant
M-PSK decisions (the grid anchored on the block's M-th-power phase), gated
by ``dd_gate``.  State = weights + history, a NamedTuple carry
(checkpoint: utils/checkpoint).  No matrix product runs here, so TF32
never applies.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

_MAX_TAPS = 128


@dataclasses.dataclass(frozen=True)
class EqConfig:
    """Equalizer configuration (the JAX package's fields and checks).

    Attributes:
      taps: FIR length L (the identity init puts the unit tap at
        ``center``).
      mu: CMA step per error sample (keep mu * errors-per-block <~ 0.25 at
        unit input power).
      r2: Godard dispersion constant (1.0 for unit-modulus PSK).
      stride: error-sample spacing in output samples (1 = every sample,
        rectangular pulses; sps = symbol-spaced decisions).
      center: identity-init tap index; default L // 2.
      leak: per-update multiplicative weight leakage (0 disables).
      freeze: filter but skip weight updates.
      mode: "cma" (blind, acquisition) or "dd" (decision-directed LMS on
        sliced M-PSK decisions, the post-lock refinement).
      dd_m: constellation order of the DD decisions.
      dd_gate: error samples with |y - a| >= dd_gate add no gradient (0
        disables the gate).
    """

    taps: int = 11
    mu: float = 1e-4
    r2: float = 1.0
    stride: int = 1
    center: int | None = None
    leak: float = 0.0
    freeze: bool = False
    mode: str = "cma"
    dd_m: int = 4
    dd_gate: float = 0.25

    def __post_init__(self):
        if not (1 <= self.taps <= _MAX_TAPS):
            raise ValueError(f"taps must be in [1, {_MAX_TAPS}]")
        if self.stride < 1:
            raise ValueError("stride must be >= 1")
        c = self.center if self.center is not None else self.taps // 2
        if not (0 <= c < self.taps):
            raise ValueError("center tap out of range")
        if self.mu < 0 or self.leak < 0:
            raise ValueError("mu and leak must be >= 0")
        if self.mode not in ("cma", "dd"):
            raise ValueError(f"unknown equalizer mode {self.mode!r}")
        if self.dd_m not in (2, 4, 8, 16, 32):
            raise ValueError(f"dd_m must be a supported PSK order; "
                             f"got {self.dd_m}")
        if self.dd_gate < 0:
            raise ValueError("dd_gate must be >= 0")

    @property
    def center_tap(self) -> int:
        return self.center if self.center is not None else self.taps // 2


class EqState(NamedTuple):
    w: torch.Tensor     # (..., L) complex64 per-channel weights
    hist: torch.Tensor  # (..., L-1) complex64 input history carry


def eq_init(cfg: EqConfig, channel_shape=(), device="cuda") -> EqState:
    """Identity weights (a unit tap at the centre) and a zero history for
    ``channel_shape`` (a tuple or an int) channels on ``device``."""
    shape = (channel_shape,) if isinstance(channel_shape, int) \
        else tuple(channel_shape)
    w = torch.zeros(shape + (cfg.taps,), dtype=torch.complex64,
                    device=device)
    w[..., cfg.center_tap] = 1.0
    hist = torch.zeros(shape + (max(cfg.taps - 1, 0),),
                       dtype=torch.complex64, device=device)
    return EqState(w=w, hist=hist)


def _ipow(z: torch.Tensor, m: int) -> torch.Tensor:
    """z**m for a positive int m by repeated squaring (the products XLA's
    integer power takes)."""
    acc = None
    while m:
        if m & 1:
            acc = z if acc is None else acc * z
        m >>= 1
        if m:
            z = z * z
    return acc


def eq_block(cfg: EqConfig, state: EqState, x):
    """Filter one block and (unless frozen or mu = 0) apply one block
    update.

    x: (..., T) complex64 (numpy or a tensor; numpy goes to the state's
    device), T a multiple of ``cfg.stride`` and T >= taps - 1.  Returns
    (new_state, y, info): sample n of y is the FIR over x[n-L+1 .. n]
    (group delay ``center_tap``); info holds ``cm_err`` (the CMA cost
    E[(|y|^2-R2)^2], or the DD mean squared error) and ``grad_norm``.
    """
    l = cfg.taps
    x = torch.as_tensor(x).to(state.w.device, torch.complex64)
    t = x.shape[-1]
    if t % cfg.stride:
        raise ValueError(f"block length {t} not a multiple of "
                         f"stride {cfg.stride}")
    if t < l - 1:
        raise ValueError(f"block length {t} shorter than taps-1 = {l - 1}")
    xx = torch.cat([state.hist.expand(x.shape[:-1] + (l - 1,)), x], dim=-1)

    # FIR: y[n] = sum_l w[l] * xx[n + L-1 - l] (L shifted multiply-adds,
    # one pass each).
    y = torch.zeros_like(x)
    for i in range(l):
        y.addcmul_(state.w[..., i:i + 1], xx[..., l - 1 - i:l - 1 - i + t])

    mod = y.real * y.real + y.imag * y.imag
    ys = y[..., ::cfg.stride]
    ms = mod[..., ::cfg.stride]
    if cfg.mode == "dd":
        # Rotation-invariant M-PSK decisions: the grid anchored on the
        # block's M-th-power phase, each symbol quantised to it.
        m = cfg.dd_m
        phi = torch.angle(_ipow(ys, m).sum(-1, keepdim=True)) / m
        theta = torch.angle(ys)
        kq = torch.round((theta - phi) * (m / (2.0 * math.pi)))
        a_ang = phi + kq * (2.0 * math.pi / m)
        a = torch.complex(torch.cos(a_ang), torch.sin(a_ang))
        e = ys - a
        e2 = e.real * e.real + e.imag * e.imag
        cm_err = e2.mean(-1)
        if cfg.dd_gate > 0:
            e = e * (e2 < cfg.dd_gate * cfg.dd_gate).to(torch.float32)
    else:
        e = ys * (ms - cfg.r2)
        cm_err = ((ms - cfg.r2) ** 2).mean(-1)

    if cfg.freeze or cfg.mu == 0.0:
        new_w = state.w
        gn = torch.zeros(cm_err.shape, dtype=torch.float32, device=x.device)
    else:
        # g[l] = sum_k e[k] conj(x[k*stride + L-1 - l]) = conj(sum_k
        # x[...] conj(e[k])): one strided view of xx per tap, multiplied by
        # conj(e) (formed once) and summed.
        ce = torch.conj(e).resolve_conj()
        g = torch.conj(torch.stack([
            (xx[..., l - 1 - i:l - 1 - i + t:cfg.stride] * ce).sum(-1)
            for i in range(l)], dim=-1)).resolve_conj()
        # Power normalisation: the CMA gradient scales with the cube of
        # the level (divide by power^2), the DD one linearly (by power),
        # so mu transfers across input scales.
        p = (xx.real * xx.real + xx.imag * xx.imag).mean(-1, keepdim=True)
        g = g / torch.clamp(p if cfg.mode == "dd" else p * p, min=1e-12)
        new_w = (state.w * (1.0 - cfg.leak) - cfg.mu * g).to(torch.complex64)
        gn = torch.sqrt((torch.abs(g) ** 2).sum(-1)).float()

    new_hist = xx[..., xx.shape[-1] - (l - 1):].clone()
    return (EqState(w=new_w, hist=new_hist), y,
            dict(cm_err=cm_err.float(), grad_norm=gn))


def make_eq_fn(cfg: EqConfig):
    """fn(state, x) -> (state, y, info) over any leading channel axes."""
    return functools.partial(eq_block, cfg)


def multipath(x: np.ndarray, taps) -> np.ndarray:
    """Test/bench helper: a causal FIR channel along the last axis (same
    length; the leading samples see a zero history)."""
    taps = np.asarray(taps, np.complex64)
    y = np.zeros_like(np.asarray(x, np.complex64))
    for d, h in enumerate(taps):
        if h == 0:
            continue
        y[..., d:] += h * x[..., :x.shape[-1] - d]
    return y
