"""Frame integrity: CRC computation and checking as GF(2) matrix products
(port of ``psk_soft_tpu/ops/crc.py:39-159``).

A CRC is linear over GF(2) up to a constant, crc(m) = m @ G ^ c0(len),
with G a host-precomputed (L, d) basis (row i = CRC of the unit message
e_i with zero init) and c0 the CRC of the zero message under the real
init/xorout.  Checking a batch of payloads is one (rows, L) x (L, d)
float32 product of 0/1 values taken mod 2: exact, since every sum is a
small integer.

Bit-serial, non-reflected convention: message bits enter MSB-of-the-
polynomial first; :func:`crc_serial` is the definitional register walk.
Presets: CRC-16/CCITT-FALSE (poly 0x1021, init 0xFFFF, "123456789" ->
0x29B1) and CRC-32/MPEG-2 (poly 0x04C11DB7, init 0xFFFFFFFF, "123456789"
-> 0x0376E6E7).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_MAX_DEGREE = 32
_MAX_MSG = 1 << 16


@dataclasses.dataclass(frozen=True)
class CrcSpec:
    """Bit-serial (non-reflected) CRC parameters."""

    degree: int
    poly: int                # without the implicit x^degree term
    init: int = 0
    xorout: int = 0

    def __post_init__(self):
        if not (1 <= self.degree <= _MAX_DEGREE):
            raise ValueError(f"degree must be in [1, {_MAX_DEGREE}]")
        for name in ("poly", "init", "xorout"):
            v = getattr(self, name)
            if not (0 <= v < (1 << self.degree)):
                raise ValueError(f"{name} out of range for degree "
                                 f"{self.degree}")
        if self.poly % 2 == 0:
            raise ValueError("poly must have the x^0 term (odd integer)")


CRC16_CCITT = CrcSpec(16, 0x1021, init=0xFFFF)
CRC32_MPEG2 = CrcSpec(32, 0x04C11DB7, init=0xFFFFFFFF)
_PRESETS = {"crc16": CRC16_CCITT, "crc32": CRC32_MPEG2}


def crc_preset(name: str) -> CrcSpec:
    try:
        return _PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown CRC preset {name!r}; "
                         f"have {sorted(_PRESETS)}") from None


def crc_serial(spec: CrcSpec, bits, init: int | None = None) -> int:
    """Definitional register walk (host oracle / basis builder); returns
    the CRC as an integer, xorout applied."""
    crc = spec.init if init is None else init
    top = 1 << (spec.degree - 1)
    mask = (1 << spec.degree) - 1
    for b in np.asarray(bits).reshape(-1):
        fb = ((crc & top) != 0) ^ (int(b) & 1)
        crc = (crc << 1) & mask
        if fb:
            crc ^= spec.poly
    return crc ^ spec.xorout


def _int_to_bits(v: int, d: int) -> np.ndarray:
    """Integer -> (d,) int8 bit plane, MSB first."""
    return np.asarray([(v >> (d - 1 - i)) & 1 for i in range(d)], np.int8)


@functools.lru_cache(maxsize=16)
def _crc_matrix(spec: CrcSpec, length: int):
    """((L, d) basis, (d,) const): crc_bits = bits @ G ^ const (mod 2),
    built in one vectorized register walk over L unit messages."""
    d = spec.degree
    reg = np.zeros((length, d), np.int8)
    poly_bits = _int_to_bits(spec.poly, d)
    for n in range(length):
        fb = reg[:, 0].copy()
        fb[n] ^= 1
        reg[:, :-1] = reg[:, 1:]
        reg[:, -1] = 0
        reg ^= fb[:, None] * poly_bits
    c0 = crc_serial(spec, np.zeros(length, np.int8))
    return np.ascontiguousarray(reg), _int_to_bits(c0, d)


def crc_bits(spec: CrcSpec, bits) -> torch.Tensor:
    """(..., L) message bits (tensor or array) -> (..., degree) int8 CRC
    bit planes, MSB first, on the input's device.  One GF(2) matrix
    product for any batch; equals :func:`crc_serial` bitwise."""
    b = torch.as_tensor(bits)
    length = b.shape[-1]
    if not (0 < length <= _MAX_MSG):
        raise ValueError(f"message length must be in [1, {_MAX_MSG}]")
    basis, const = _crc_matrix(spec, length)
    g = torch.as_tensor(basis, device=b.device).to(torch.float32)
    c = torch.as_tensor(const, device=b.device)
    acc = b.to(torch.float32) @ g
    return (acc.to(torch.int32) & 1).to(torch.int8) ^ c


def append_crc(spec: CrcSpec, bits) -> np.ndarray:
    """TX helper: message || CRC(message), MSB-first CRC field (numpy)."""
    b = np.asarray(bits, np.int8)
    crc = crc_bits(spec, b).numpy()
    return np.concatenate([b, crc], axis=-1)


def check_crc(spec: CrcSpec, bits, device=None):
    """(..., L+degree) received bits -> ((..., L) message, (...,) ok) as
    numpy.  The CRC is computed on ``device``: by default the device of
    ``bits`` when it is a tensor, else the CPU."""
    b = torch.as_tensor(bits, device=device).to(torch.int8)
    d = spec.degree
    if b.shape[-1] <= d:
        raise ValueError(f"need more than {d} bits (message + CRC)")
    msg = b[..., :-d]
    ok = (crc_bits(spec, msg) == b[..., -d:]).all(dim=-1)
    return msg.cpu().numpy(), ok.cpu().numpy()
