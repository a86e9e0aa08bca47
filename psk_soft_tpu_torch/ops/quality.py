"""Per-channel signal quality of a block of soft decisions: M2M4 SNR, EVM
and carrier lock (port of ``psk_soft_tpu/ops/quality.py:40-150``).

Three single-pass moment reductions over the (..., S) soft plane on its
device:

- **M2M4 SNR** (constant-modulus kurtosis 1, complex AWGN): with M2 =
  E|s|^2 and M4 = E|s|^4, signal S = sqrt(2 M2^2 - M4), noise N = M2 - S,
  snr = S / N.  Blind: no decisions, no reference constellation.
- **Carrier lock** |E[(s/|s|)^M]| in [0, 1]: the M-th power removes the
  PSK modulation, so a locked channel concentrates u^M on one angle (lock
  -> 1) and an unlocked or noise-only one spreads it (lock -> 0).
- **EVM** (decision-directed, rotation-free): per symbol the phase error
  is delta = angle(u^M conj(zbar)) / M around the measured cluster centre
  zbar = E[u^M]; with A = E|s| the error vector to the amplitude-A point
  at angle theta - delta has |.|^2 = |s|^2 + A^2 - 2|s|A cos(delta), and
  EVM_rms = sqrt(E[.]) / A.

M is an int or a per-channel tensor (mixed banks); ``valid`` gates the
warm-up.  Rows with no valid symbol report count 0 and zeros.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class QualityBlock(NamedTuple):
    """Per-channel block quality (shapes = soft.shape[:-1]), linear units
    (convert with :func:`snr_db` / :func:`evm_pct`)."""

    count: torch.Tensor   # int32 valid symbols measured
    amp: torch.Tensor     # mean |s| (the constellation radius estimate)
    power: torch.Tensor   # mean |s|^2 (M2)
    snr: torch.Tensor     # M2M4 moments SNR estimate (linear)
    lock: torch.Tensor    # |E[(s/|s|)^M]| in [0, 1]
    evm: torch.Tensor     # RMS error-vector magnitude / amp (fraction)
    center: torch.Tensor  # complex E[(s/|s|)^M] (the cluster centre)


def block_quality(soft: torch.Tensor, m, valid=None,
                  eps: float = 1e-20) -> QualityBlock:
    """Quality metrics of one block of soft decisions.

    soft: (..., S) complex64 tensor (any leading channel axes); m: an int
    or a (...,) tensor broadcast against the leading axes; valid: optional
    (..., S) bool mask (None = all valid).  Runs on soft's device.
    """
    soft = torch.as_tensor(soft)
    re, im = soft.real.float(), soft.imag.float()
    mag2 = re * re + im * im
    mag = torch.sqrt(mag2)
    if valid is None:
        w = torch.ones(soft.shape, dtype=torch.float32, device=soft.device)
    else:
        w = torch.as_tensor(valid, device=soft.device).to(torch.float32)
    n = w.sum(-1)
    inv_n = 1.0 / torch.clamp(n, min=1.0)

    amp = (w * mag).sum(-1) * inv_n
    m2 = (w * mag2).sum(-1) * inv_n
    m4 = (w * mag2 * mag2).sum(-1) * inv_n

    # M2M4: S = sqrt(2 M2^2 - M4), N = M2 - S.  The float32 moment
    # cancellation caps the range: 60 dB means "cleaner than measurable".
    s_pow = torch.sqrt(torch.clamp(2.0 * m2 * m2 - m4, min=0.0))
    n_pow = torch.clamp(m2 - s_pow, min=eps)
    snr = torch.clamp(s_pow / n_pow, max=1e6)

    # Modulation-removed unit phasors u^M (per-channel M supported).
    theta = torch.atan2(im, re)
    m_t = torch.as_tensor(m, dtype=torch.float32, device=soft.device)
    m_b = m_t[..., None] if m_t.ndim else m_t
    mtheta = m_b * theta
    z = torch.complex(torch.cos(mtheta), torch.sin(mtheta))
    center = (w * z).sum(-1) * inv_n
    lock = torch.abs(center)

    # Rotation-free decision-directed EVM around the measured centre.
    czn = torch.conj(center) / torch.clamp(lock, min=eps)
    delta = torch.angle(z * czn[..., None]) / torch.clamp(m_b, min=1.0)
    ev2 = mag2 + (amp * amp)[..., None] \
        - 2.0 * mag * amp[..., None] * torch.cos(delta)
    evm = torch.sqrt(torch.clamp((w * ev2).sum(-1) * inv_n, min=0.0)) \
        / torch.clamp(amp, min=eps)

    has = n > 0
    zf = torch.zeros_like(amp)
    return QualityBlock(
        count=n.to(torch.int32),
        amp=torch.where(has, amp, zf),
        power=torch.where(has, m2, zf),
        snr=torch.where(has, snr, zf),
        lock=torch.where(has, lock, zf),
        evm=torch.where(has, evm, zf),
        center=torch.where(has, center, torch.zeros_like(center)))


def make_quality_fn(m):
    """fn(soft, valid=None) -> QualityBlock with ``m`` (an int or a
    per-channel tensor) closed over."""
    return functools.partial(block_quality, m=m)


def snr_db(snr_linear) -> np.ndarray:
    """Linear SNR -> dB (host helper; floors at -100 dB)."""
    s = np.asarray(snr_linear, np.float64)
    return (10.0 * np.log10(np.maximum(s, 1e-10))).astype(np.float32)


def evm_pct(evm_fraction) -> np.ndarray:
    """EVM fraction -> percent (host helper)."""
    return (100.0 * np.asarray(evm_fraction, np.float64)).astype(np.float32)
