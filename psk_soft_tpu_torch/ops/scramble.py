"""Scrambling / energy dispersal: LFSR sequences (port of
``psk_soft_tpu/ops/scramble.py``).

- **Additive (frame-synchronous)**: XOR with an LFSR keystream re-seeded
  at each frame start.  The LFSR is linear over GF(2), so a length-L
  keystream is ks = seed @ K (mod 2) with a host-precomputed (r, L) basis:
  one float32 matrix product of 0/1 values on the bits' device (exact:
  every sum is a small integer), taken mod 2.
- **Multiplicative (self-synchronizing)**: the descrambler is
  feed-forward, y[n] = x[n] ^ x[n-t1] ^ x[n-t2], a few shifted XOR planes;
  the matching scrambler is recursive and lives on the transmit side (a
  loop over steps here).

Polynomial convention: taps as an integer mask over state bits
``[x^{-1} .. x^{-r}]``.  Presets are the ITU O.150 PRBS generators:
PRBS7 = x^7+x^6+1, PRBS15 = x^15+x^14+1, PRBS23 = x^23+x^18+1; the
default seed is all ones.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_MAX_DEGREE = 32
_MAX_BLOCK = 1 << 16     # keystream blocks are per frame


@dataclasses.dataclass(frozen=True)
class Lfsr:
    """Fibonacci LFSR over the output recurrence.

    State s with s_i = a[n+i]: s_0 is the next output bit, s_{r-1} the
    most recently fed-back bit.  Each step outputs s_0, computes the
    feedback a[n+r] = XOR of the masked s_i, and shifts.  For a
    characteristic polynomial x^r + x^k + 1, ``taps = (1 << k) | 1``.

    Attributes:
      degree: register length r.
      taps: feedback mask over s_0..s_{r-1} (bit i taps s_i).
      seed: initial state integer, bit i = s_i (default all ones; must be
        nonzero).
    """

    degree: int
    taps: int
    seed: int | None = None

    def __post_init__(self):
        if not (2 <= self.degree <= _MAX_DEGREE):
            raise ValueError(f"degree must be in [2, {_MAX_DEGREE}]")
        if not (0 < self.taps < (1 << self.degree)):
            raise ValueError("taps mask out of range")
        s = self.seed_value
        if not (0 < s < (1 << self.degree)):
            raise ValueError("seed must be a nonzero r-bit state")

    @property
    def seed_value(self) -> int:
        return ((1 << self.degree) - 1) if self.seed is None else self.seed

    def seed_bits(self) -> np.ndarray:
        """(r,) int8 state bits, newest first."""
        return np.asarray([(self.seed_value >> i) & 1
                           for i in range(self.degree)], np.int8)


def prbs7(seed: int | None = None) -> Lfsr:
    """ITU O.150 PRBS7: x^7 + x^6 + 1 (period 127)."""
    return Lfsr(7, (1 << 6) | 1, seed)


def prbs15(seed: int | None = None) -> Lfsr:
    """ITU O.150 PRBS15: x^15 + x^14 + 1 (period 32767)."""
    return Lfsr(15, (1 << 14) | 1, seed)


def prbs23(seed: int | None = None) -> Lfsr:
    """ITU O.150 PRBS23: x^23 + x^18 + 1 (period 8388607)."""
    return Lfsr(23, (1 << 18) | 1, seed)


_PRESETS = {"prbs7": prbs7, "prbs15": prbs15, "prbs23": prbs23}


def lfsr_preset(name: str, seed: int | None = None) -> Lfsr:
    """Look up a named PRBS generator (prbs7 / prbs15 / prbs23)."""
    try:
        return _PRESETS[name](seed)
    except KeyError:
        raise ValueError(f"unknown LFSR preset {name!r}; "
                         f"have {sorted(_PRESETS)}") from None


@functools.lru_cache(maxsize=16)
def _basis_matrix(degree: int, taps: int, length: int) -> np.ndarray:
    """(r, L) GF(2) basis: row i is the keystream from basis seed e_i,
    all rows extended together by the recurrence (host precompute)."""
    r = degree
    tap_idx = np.flatnonzero([(taps >> i) & 1 for i in range(r)])
    a = np.zeros((r, length + r), np.int8)
    a[:, :r] = np.eye(r, dtype=np.int8)
    for n in range(length):
        v = a[:, n + tap_idx[0]].copy()
        for i in tap_idx[1:]:
            v ^= a[:, n + i]
        a[:, n + r] = v
    return np.ascontiguousarray(a[:, :length])


def keystream(lfsr: Lfsr, length: int) -> np.ndarray:
    """(length,) keystream for the configured seed (host helper)."""
    k = _basis_matrix(lfsr.degree, lfsr.taps, length)
    return (lfsr.seed_bits() @ k) & 1


def additive_scramble(lfsr: Lfsr, bits, seeds=None) -> torch.Tensor:
    """XOR a (..., L) bit plane with per-row LFSR keystreams, on the bits'
    device; returns int8.

    Self-inverse: descrambling is scrambling.  ``seeds`` is an optional
    (..., r) 0/1 plane of per-row register states; the default is the
    LFSR's configured seed for every row.
    """
    b = torch.as_tensor(bits)
    length = b.shape[-1]
    if length > _MAX_BLOCK:
        raise ValueError(f"block of {length} bits exceeds {_MAX_BLOCK}")
    want = tuple(b.shape[:-1]) + (lfsr.degree,)
    if seeds is None:
        s = torch.as_tensor(lfsr.seed_bits(), device=b.device).expand(want)
    else:
        s = torch.as_tensor(seeds, device=b.device).to(torch.int8)
        if tuple(s.shape) != want:
            raise ValueError(f"seeds shape {tuple(s.shape)} != {want}")
    basis = torch.as_tensor(_basis_matrix(lfsr.degree, lfsr.taps, length),
                            device=b.device)
    ks = (s.to(torch.float32) @ basis.to(torch.float32)).to(torch.int32) & 1
    return (b.to(torch.int32) ^ ks).to(torch.int8)


def _check_taps(taps: tuple) -> int:
    if min(taps) < 1:
        raise ValueError("tap delays must be >= 1")
    return max(taps)


def selfsync_descramble(bits, taps: tuple) -> torch.Tensor:
    """Self-synchronizing descrambler: y[n] = x[n] ^ x[n-t1] ^ ..., bits
    before the stream start taken as 0; int8 on the bits' device."""
    x = torch.as_tensor(bits).to(torch.int8)
    d_max = _check_taps(taps)
    t = x.shape[-1]
    xx = torch.cat([torch.zeros(x.shape[:-1] + (d_max,), dtype=torch.int8,
                                device=x.device), x], dim=-1)
    y = x
    for d in taps:
        y = y ^ xx[..., d_max - d:d_max - d + t]
    return y


def selfsync_scramble(bits, taps: tuple) -> torch.Tensor:
    """Transmit-side multiplicative scrambler, y[n] = x[n] ^ y[n-t1] ^
    ... (recursive over GF(2), a loop over steps)."""
    x = torch.as_tensor(bits).to(torch.int8)
    d_max = _check_taps(taps)
    t = x.shape[-1]
    y = torch.cat([torch.zeros(x.shape[:-1] + (d_max,), dtype=torch.int8,
                               device=x.device), torch.zeros_like(x)], dim=-1)
    for n in range(t):
        v = x[..., n]
        for d in taps:
            v = v ^ y[..., d_max + n - d]
        y[..., d_max + n] = v
    return y[..., d_max:]
