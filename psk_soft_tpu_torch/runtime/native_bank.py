"""ctypes bindings for the native channel banks (port of
``psk_soft_tpu/runtime/native_bank.py:92-249`` over ``native/pskbank.cpp``).

Both banks take sample-interleaved multichannel frames (a channelizer's
natural order).  :class:`NativePlaneBank` deframes them straight to
TIME-MAJOR re/im planes -- kernel B1's (T, C) input layout;
:class:`NativeChannelBank` to channel-major (C, n) complex64 blocks, the
engines' ``push_block`` layout.  The library is
compiled from ``native/pskbank.cpp`` with g++ into
``build/psk_soft_tpu_torch/`` at first use (the prebuilt ``.so`` files in
``native/`` belong to the JAX package and are not loaded).

Overflow semantics: a push that would overflow drops everything queued and
flags the next pop (``flushed=True``), which the consumer answers with a
state reset (the reference's BulkIO queue flush, cpp/psk_soft.cpp:353-357).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np

from ..utils.build import REPO_ROOT, build_shared

SOURCE = REPO_ROOT / "native" / "pskbank.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]


@functools.lru_cache(maxsize=None)
def _load_lib():
    path, _ = build_shared(SOURCE, "pskbank", ["g++"], CXX_FLAGS)
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pskbank_create.restype = vp
    lib.pskbank_create.argtypes = [i32, i64]
    lib.pskbank_destroy.argtypes = [vp]
    lib.pskbank_push_interleaved.restype = ctypes.c_int
    lib.pskbank_push_interleaved.argtypes = [vp, f32p, i64]
    lib.pskbank_available.restype = i64
    lib.pskbank_available.argtypes = [vp, i64, i64]
    lib.pskbank_pop_block.restype = i64
    lib.pskbank_pop_block.argtypes = [vp, f32p, i64, ctypes.POINTER(i32)]
    lib.pskbank_close.argtypes = [vp]
    lib.pskbank_depth.restype = i64
    lib.pskbank_depth.argtypes = [vp]
    lib.pskbank_stats.argtypes = [vp, ctypes.POINTER(ctypes.c_uint64)]
    lib.pskplane_create.restype = vp
    lib.pskplane_create.argtypes = [i32, i64, i32]
    lib.pskplane_destroy.argtypes = [vp]
    lib.pskplane_push_interleaved.restype = ctypes.c_int
    lib.pskplane_push_interleaved.argtypes = [vp, vp, i64]
    lib.pskplane_available.restype = i64
    lib.pskplane_available.argtypes = [vp, i64, i64]
    lib.pskplane_pop_planes.restype = i64
    lib.pskplane_pop_planes.argtypes = [vp, vp, vp, i64,
                                        ctypes.POINTER(i32)]
    lib.pskplane_close.argtypes = [vp]
    lib.pskplane_depth.restype = i64
    lib.pskplane_depth.argtypes = [vp]
    lib.pskplane_stats.argtypes = [vp, ctypes.POINTER(ctypes.c_uint64)]
    return lib


@dataclasses.dataclass
class BankStats:
    frames_in: int
    samples_out: int
    flushes: int
    dropped_samples: int


class NativeChannelBank:
    """Bounded lockstep multichannel ring with native deinterleave to
    channel-major (C, n) complex64 blocks.

    ``capacity_samples`` bounds the queued depth per channel; a push that
    would exceed it flushes the ring and the next :meth:`pop_block`
    reports ``flushed=True``.
    """

    def __init__(self, channels: int, capacity_samples: int = 1 << 20):
        self._lib = _load_lib()
        self.channels = int(channels)
        self._h = self._lib.pskbank_create(self.channels,
                                           int(capacity_samples))
        if not self._h:
            raise ValueError("pskbank_create failed (bad channels/capacity)")

    def push_interleaved(self, frames: np.ndarray) -> bool:
        """Push sample-interleaved complex64 data: (n, C), (n*C,), or raw
        float32 of length 2*n*C.  Returns True on overflow flush."""
        arr = np.asarray(frames)
        if np.iscomplexobj(arr):
            arr = arr.astype(np.complex64, copy=False).view(np.float32)
        arr = np.ascontiguousarray(arr, np.float32).ravel()
        if arr.size % (2 * self.channels):
            raise ValueError(
                f"push must be whole frames of {self.channels} channels")
        n_frames = arr.size // (2 * self.channels)
        rc = self._lib.pskbank_push_interleaved(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_frames)
        if rc < 0:
            raise RuntimeError(f"pskbank_push_interleaved failed: {rc}")
        return bool(rc)

    def pop_block(self, n: int, timeout: Optional[float] = None):
        """Blocking pop of ``(block, flushed)`` with a channel-major (C, n)
        complex64 block; ``flushed`` reports (and clears) the overflow
        marker set since the last pop.  None on timeout."""
        timeout_ms = -1 if timeout is None else max(0, int(timeout * 1000))
        avail = self._lib.pskbank_available(self._h, int(n), timeout_ms)
        if avail < n:
            return None
        out = np.empty((self.channels, n), np.complex64)
        flushed = ctypes.c_int32()
        rc = self._lib.pskbank_pop_block(
            self._h, out.view(np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            int(n), ctypes.byref(flushed))
        if rc < 0:
            return None     # raced with a concurrent consumer's pop
        return out, bool(flushed.value)

    def close(self) -> None:
        self._lib.pskbank_close(self._h)

    def depth(self) -> int:
        return int(self._lib.pskbank_depth(self._h))

    def stats(self) -> BankStats:
        out = (ctypes.c_uint64 * 4)()
        self._lib.pskbank_stats(self._h, out)
        return BankStats(*[int(v) for v in out])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pskbank_destroy(self._h)
            self._h = None


class NativePlaneBank:
    """Lockstep multichannel ring that deframes to time-major re/im planes.

    Interleaved frames are already time-major across channels, so the
    native stage is a stride-2 re/im split and a pop is two contiguous
    memcpys.  ``dtype`` selects the wire format: "f32" (complex64 frames)
    or "i16" (int16 I/Q pairs, the REDHAWK dataShort wire, half the bytes;
    it pairs with kernel B1's int16 ingest,
    ``FullKernelBatchEngine(ingest_scale=...)``).
    """

    def __init__(self, channels: int, capacity_samples: int = 1 << 20,
                 dtype: str = "f32"):
        if dtype not in ("f32", "i16"):
            raise ValueError(f"dtype must be 'f32' or 'i16', got {dtype!r}")
        self._lib = _load_lib()
        self.channels = int(channels)
        self.dtype = dtype
        self._np_dtype = np.float32 if dtype == "f32" else np.int16
        self._h = self._lib.pskplane_create(
            self.channels, int(capacity_samples), 4 if dtype == "f32" else 2)
        if not self._h:
            raise ValueError("pskplane_create failed (bad args)")

    def push_interleaved(self, frames: np.ndarray) -> bool:
        """Push interleaved frames: complex64 ((n, C)) or flat pairs of the
        wire dtype, length 2*n*C.  Returns True on overflow flush."""
        arr = np.asarray(frames)
        if np.iscomplexobj(arr):
            if self.dtype != "f32":
                raise ValueError("i16 bank takes int16 I/Q pairs")
            arr = arr.astype(np.complex64, copy=False).view(np.float32)
        arr = np.ascontiguousarray(arr, self._np_dtype).ravel()
        if arr.size % (2 * self.channels):
            raise ValueError(
                f"push must be whole frames of {self.channels} channels")
        n_frames = arr.size // (2 * self.channels)
        rc = self._lib.pskplane_push_interleaved(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), n_frames)
        if rc < 0:
            raise RuntimeError(f"pskplane_push_interleaved failed: {rc}")
        return bool(rc)

    def pop_planes(self, n: int, timeout: Optional[float] = None):
        """Blocking pop of ``(re, im, flushed)`` with (n, C) plane arrays of
        the wire dtype.  None on timeout."""
        timeout_ms = -1 if timeout is None else max(0, int(timeout * 1000))
        avail = self._lib.pskplane_available(self._h, int(n), timeout_ms)
        if avail < n:
            return None
        re = np.empty((n, self.channels), self._np_dtype)
        im = np.empty((n, self.channels), self._np_dtype)
        flushed = ctypes.c_int32()
        rc = self._lib.pskplane_pop_planes(
            self._h, re.ctypes.data_as(ctypes.c_void_p),
            im.ctypes.data_as(ctypes.c_void_p), int(n),
            ctypes.byref(flushed))
        if rc < 0:
            return None     # raced with a concurrent consumer's pop
        return re, im, bool(flushed.value)

    def close(self) -> None:
        self._lib.pskplane_close(self._h)

    def depth(self) -> int:
        return int(self._lib.pskplane_depth(self._h))

    def stats(self) -> BankStats:
        out = (ctypes.c_uint64 * 4)()
        self._lib.pskplane_stats(self._h, out)
        return BankStats(*[int(v) for v in out])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pskplane_destroy(self._h)
            self._h = None
