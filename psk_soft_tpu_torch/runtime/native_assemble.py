"""ctypes bindings for the bank engine's host packet assembly
(``psk_soft_tpu_torch/csrc/assemble.cpp``).

Each function turns fetched time-major (S, C) kernel planes into one
port's channel-major payload in one native pass, writing into a fresh
numpy array, so no two blocks' packets share memory.  The library is
compiled with g++ into ``build/psk_soft_tpu_torch/`` at first use;
:func:`load` builds it ahead of the first block (the engines' assembler
calls it when it is made).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.build import REPO_ROOT, build_shared, load_once

SOURCE = REPO_ROOT / "psk_soft_tpu_torch" / "csrc" / "assemble.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_INT_PLANES = (np.int8, np.int32)
_VP, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {
    "psk_soft_f32": [_VP, _VP, _I64, _VP],
    "psk_soft_i8": [_VP, _VP, _I64, ctypes.c_float, _VP],
    "psk_bits_i8": [_VP, _I64, _I64, ctypes.c_int32, _VP],
    "psk_bits_i32": [_VP, _I64, _I64, ctypes.c_int32, _VP],
    "psk_phase": [_VP, _I64, _I64, _VP],
    "psk_index_i8": [_VP, _I64, _I64, _VP],
    "psk_index_i32": [_VP, _I64, _I64, _VP],
}


@load_once
def load():
    path, _ = build_shared(SOURCE, "assemble", ["g++"], CXX_FLAGS)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, None
    return lib


def _plane(a, dtypes) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.ndim != 2 or a.dtype not in dtypes:
        names = "/".join(np.dtype(d).name for d in dtypes)
        raise ValueError(f"expected a 2-D {names} plane, got "
                         f"{a.dtype} {a.shape}")
    return a


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def soft(re, im, scale: float | None = None) -> np.ndarray:
    """(S, C) complex64 soft decisions from float32 re/im planes, or from
    int8 ones dequantized as ``q * float32(1 / scale)``."""
    dtypes = (np.int8,) if scale else (np.float32,)
    re, im = _plane(re, dtypes), _plane(im, dtypes)
    if re.shape != im.shape:
        raise ValueError(f"re {re.shape} and im {im.shape} differ")
    out = np.empty(re.shape, np.complex64)
    if scale:
        load().psk_soft_i8(_ptr(re), _ptr(im), re.size,
                           1.0 / float(scale), _ptr(out))
    else:
        load().psk_soft_f32(_ptr(re), _ptr(im), re.size, _ptr(out))
    return out


def bits(packed, nb: int) -> np.ndarray:
    """int16 (C, S*nb) bits, LSB first, from a packed int8/int32 (S, C)
    plane."""
    packed = _plane(packed, _INT_PLANES)
    if not 1 <= nb <= 32:
        raise ValueError(f"nb must be in [1, 32], got {nb}")
    s, c = packed.shape
    out = np.empty((c, s * nb), np.int16)
    fn = (load().psk_bits_i8 if packed.dtype == np.int8
          else load().psk_bits_i32)
    fn(_ptr(packed), s, c, nb, _ptr(out))
    return out


def phase(plane) -> np.ndarray:
    """Contiguous float32 (C, S) from a float32 (S, C) plane."""
    plane = _plane(plane, (np.float32,))
    s, c = plane.shape
    out = np.empty((c, s), np.float32)
    load().psk_phase(_ptr(plane), s, c, _ptr(out))
    return out


def sample_index(plane) -> np.ndarray:
    """Contiguous int16 (C, S) from an int8/int32 (S, C) plane (int32
    values wrap to 16 bits)."""
    plane = _plane(plane, _INT_PLANES)
    s, c = plane.shape
    out = np.empty((c, s), np.int16)
    fn = (load().psk_index_i8 if plane.dtype == np.int8
          else load().psk_index_i32)
    fn(_ptr(plane), s, c, _ptr(out))
    return out
