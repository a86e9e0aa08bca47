"""Block bit interleaving between the FEC and the symbol mapper (port of
``psk_soft_tpu/ops/interleave.py``).

Write by rows / read by columns: bit i of the (rows x cols) block moves to
position (i % cols) * rows + i // cols.  Both directions are one index
gather on the bits' device, with the permutation built once per (length,
rows, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _perm(length: int, rows: int) -> np.ndarray:
    """interleaved[j] = flat[_perm[j]] (write-rows / read-columns)."""
    if rows < 1 or length % rows:
        raise ValueError(f"length {length} not a multiple of rows {rows}")
    return np.arange(length).reshape(rows, -1).T.reshape(-1)


@functools.lru_cache(maxsize=64)
def _index(length: int, rows: int, device: torch.device,
           inverse: bool) -> torch.Tensor:
    perm = _perm(length, rows)
    return torch.as_tensor(np.argsort(perm) if inverse else perm,
                           device=device)


def interleave(bits, rows: int) -> torch.Tensor:
    """(..., L) -> (..., L) block-interleaved (rows x L/rows)."""
    b = torch.as_tensor(bits)
    return b[..., _index(b.shape[-1], rows, b.device, False)]


def deinterleave(bits, rows: int) -> torch.Tensor:
    """Exact inverse of :func:`interleave` (same rows)."""
    b = torch.as_tensor(bits)
    return b[..., _index(b.shape[-1], rows, b.device, True)]
