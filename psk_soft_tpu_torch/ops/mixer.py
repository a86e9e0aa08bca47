"""NCO derotation (complex mixer) over time-major planes
(port of ``psk_soft_tpu/ops/mixer.py:26-57``).

The M-th-power tracker locks only while the per-symbol phase step
``M * 2pi * f * sps`` stays well under pi; larger carrier offsets are
estimated first (``eval/cfo.acquire_cfo``) and mixed down here before the
demod.  Elementwise work on the (T, C) planes the kernel reads.  Streaming:
the returned ``phase_end`` is the next block's ``phase0``, wrapped so the
float32 angle never grows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


def derotate(x_re: torch.Tensor, x_im: torch.Tensor, freq: torch.Tensor,
             phase0: torch.Tensor):
    """Multiply (T, C) planes by exp(-j*(2pi*freq*t + phase0)) per channel.

    freq: (C,) cycles per input sample; phase0: (C,) radians, float32.
    Returns (y_re, y_im, phase_end), phase_end wrapped to [-pi, pi).

    The float32 angle is formed as the JAX package forms it: ``w = 2pi *
    freq`` rounded to float32, then ``w * t + phase0`` rounded once (XLA
    fuses it into one multiply-add; the float64 product of two float32
    values is exact, so rounding the float64 sum once gives the same
    float32).  At t ~ 4096 the angle's ulp is ~2.4e-4 rad, so any other
    rounding would move the output by that much.  cos and sin are taken
    in float64 of that float32 angle: PyTorch's float32 CPU cos is not
    accurate to float32 at angles of thousands of radians.  phase_end is
    evaluated in float64 and rounded once (the JAX package's may differ
    from it by about one float32 ulp).
    """
    T = x_re.shape[0]
    t = torch.arange(T, dtype=torch.float64, device=x_re.device)[:, None]
    w = (TWO_PI * freq).double()
    ang = (-(w[None, :] * t + phase0.double()[None, :])).float().double()
    c, s = torch.cos(ang).float(), torch.sin(ang).float()
    y_re = x_re * c - x_im * s
    y_im = x_re * s + x_im * c
    phase_end = phase0.double() + TWO_PI * freq.double() * T
    phase_end = torch.remainder(phase_end + math.pi, TWO_PI) - math.pi
    return y_re, y_im, phase_end.float()


def derotate_host(x: np.ndarray, freq, phase0=0.0) -> np.ndarray:
    """Channel-major complex host form (float64 angle): x (C, T) or (T,),
    freq cycles/sample scalar or (C,)."""
    x = np.asarray(x)
    one = x.ndim == 1
    x2 = x[None, :] if one else x
    f = np.broadcast_to(np.asarray(freq, np.float64), (x2.shape[0],))
    p0 = np.broadcast_to(np.asarray(phase0, np.float64), (x2.shape[0],))
    t = np.arange(x2.shape[1], dtype=np.float64)
    y = x2 * np.exp(-1j * (TWO_PI * f[:, None] * t[None, :]
                           + p0[:, None]))
    y = y.astype(np.complex64)
    return y[0] if one else y
