"""Symbol -> bit slicers for BPSK / QPSK / 8-PSK (+ 16/32-PSK extension)
(port of ``psk_soft_tpu/ops/slicers.py:25-196``).

The documented sign-based mapping of ``psk_soft.scd.xml:42-63``, bits
LSB-first.  Each slicer returns an ``(..., 3)`` int8 tensor (``log2 M`` wide
for 16/32-PSK) padded with zeros past ``bits_per_symbol``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def slice_bpsk(soft: torch.Tensor) -> torch.Tensor:
    """BPSK: phase 0 -> 0, pi -> 1."""
    b0 = (soft.real < 0).to(torch.int8)
    z = torch.zeros_like(b0)
    return torch.stack([b0, z, z], dim=-1)


def slice_qpsk(soft: torch.Tensor) -> torch.Tensor:
    """QPSK quadrants (+,+) -> 00, (-,+) -> 01, (-,-) -> 10, (+,-) -> 11,
    value ``b0 + 2*b1``, bits emitted [b0, b1]."""
    sr = (soft.real < 0).to(torch.int8)
    si = (soft.imag < 0).to(torch.int8)
    b0 = sr ^ si
    return torch.stack([b0, si, torch.zeros_like(b0)], dim=-1)


def slice_8psk(soft: torch.Tensor) -> torch.Tensor:
    """8-PSK: phase k*pi/4 -> binary k, LSB-first."""
    theta = torch.atan2(soft.imag, soft.real)
    softsym = theta / math.pi * 4.0
    softsym = torch.where(softsym < -0.5, softsym + 8.0, softsym)
    sym = torch.floor(softsym + 0.5).to(torch.int32) & 7
    return torch.stack([((sym >> i) & 1).to(torch.int8) for i in range(3)],
                       dim=-1)


def mpsk_code(m: int, soft: torch.Tensor) -> torch.Tensor:
    """Generalized M-PSK symbol index for power-of-two m >= 8: phase
    k*2pi/M -> binary k (values below -0.5 wrap up by +m; m aliases to 0)."""
    theta = torch.atan2(soft.imag, soft.real)
    softsym = theta * (m / (2.0 * math.pi))
    softsym = torch.where(softsym < -0.5, softsym + m, softsym)
    return torch.floor(softsym + 0.5).to(torch.int32) & (m - 1)


def slice_mpsk(m: int, soft: torch.Tensor) -> torch.Tensor:
    """Generalized M-PSK slicer, ``(..., max(3, log2 m))`` int8 planes."""
    nb = max(3, (m - 1).bit_length())
    sym = mpsk_code(m, soft)
    return torch.stack([((sym >> i) & 1).to(torch.int8) for i in range(nb)],
                       dim=-1)


def slice_bits(constellation_size: int, soft: torch.Tensor) -> torch.Tensor:
    """Dispatch on the constellation size."""
    if constellation_size == 2:
        return slice_bpsk(soft)
    if constellation_size == 4:
        return slice_qpsk(soft)
    if constellation_size in (8, 16, 32):
        return slice_mpsk(constellation_size, soft)
    raise ValueError(f"unsupported constellation size {constellation_size}")


def slice_code_dynamic(m_size: torch.Tensor,
                       soft: torch.Tensor) -> torch.Tensor:
    """Packed symbol code with a per-element constellation size (mixed
    banks): the BPSK, QPSK and generalized M-PSK codes computed for every
    element and selected by ``m_size`` (which broadcasts against ``soft``);
    the M-PSK code wraps values below -0.5 up by +m and aliases m to 0.  A
    NaN soft value codes as 0 (XLA's and the kernel's float-to-int rule)."""
    m = torch.broadcast_to(torch.as_tensor(m_size, device=soft.device),
                           soft.shape)
    code2 = (soft.real < 0).to(torch.int32)
    si = (soft.imag < 0).to(torch.int32)
    code4 = (code2 ^ si) + 2 * si
    theta = torch.atan2(soft.imag, soft.real)
    mf = m.to(torch.float32)
    ss = theta * (mf / (2.0 * math.pi))
    ss = torch.where(ss < -0.5, ss + mf, ss)
    codem = torch.floor(torch.nan_to_num(ss + 0.5, nan=0.0)).to(torch.int32)
    mi = m.to(torch.int32)
    codem = torch.where(codem >= mi, codem - mi, codem)
    return torch.where(m == 2, code2, torch.where(m == 4, code4, codem))


def slice_bits_dynamic(m_size: torch.Tensor, soft: torch.Tensor,
                       max_bits: int = 3) -> torch.Tensor:
    """Slicer with a per-element constellation size: ``(..., max_bits)``
    int8 planes LSB-first (3 covers banks of {2, 4, 8}; 4 or 5 with 16- or
    32-PSK channels)."""
    code = slice_code_dynamic(m_size, soft)
    return torch.stack([((code >> i) & 1).to(torch.int8)
                        for i in range(max_bits)], dim=-1)


def bit_labels(m: int, labeling: str = "scd") -> np.ndarray:
    """(m, log2 m) int8 bit labels of symbol index k, LSB-first (port of
    ``psk_soft_tpu/ops/slicers.py:158``).

    labeling="scd": the documented port mapping above, applied to the
    ideal points :func:`..framesync.psk_points`.  labeling="gray":
    binary-reflected Gray code (label = k ^ (k >> 1)), the coded-
    transmission mapping.  A host numpy table.
    """
    if m not in (2, 4, 8, 16, 32):
        raise ValueError(f"unsupported constellation size {m}")
    nb = max(int(np.log2(m)), 1)
    k = np.arange(m)
    if labeling == "gray":
        code = k ^ (k >> 1)
    elif labeling == "scd":
        from .framesync import psk_points
        pts = psk_points(k, m)
        if m == 2:
            code = (pts.real < 0).astype(np.int64)
        elif m == 4:
            sr = (pts.real < 0).astype(np.int64)
            si = (pts.imag < 0).astype(np.int64)
            code = (sr ^ si) + 2 * si
        else:
            softsym = np.angle(pts) * (m / (2.0 * np.pi))
            softsym = np.where(softsym < -0.5, softsym + m, softsym)
            code = np.floor(softsym + 0.5).astype(np.int64) & (m - 1)
    else:
        raise ValueError(f"unknown labeling {labeling!r}")
    return ((code[:, None] >> np.arange(nb)) & 1).astype(np.int8)
