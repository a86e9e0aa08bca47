"""ctypes bindings for the native channel banks (port of
``psk_soft_tpu/runtime/native_bank.py:92-249``).

Both banks take sample-interleaved multichannel frames (a channelizer's
natural order).  :class:`NativePlaneBank` deframes them straight to
TIME-MAJOR re/im planes -- kernel B1's (T, C) input layout -- into
segments of its own ring and pops views of them;
:class:`NativeChannelBank` deframes to channel-major (C, n) complex64
blocks, the engines' ``push_block`` layout.  The libraries are compiled
with g++ into ``build/psk_soft_tpu_torch/`` at first use: the channel bank
from ``native/pskbank.cpp`` (the prebuilt ``.so`` files in ``native/``
belong to the JAX package and are not loaded), the plane bank's split from
``psk_soft_tpu_torch/csrc/planebank.cpp``.

Overflow semantics: a push that would overflow drops everything queued and
flags the next pop (``flushed=True``), which the consumer answers with a
state reset (the reference's BulkIO queue flush, cpp/psk_soft.cpp:353-357).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from ..utils.build import REPO_ROOT, build_shared, load_once
from ..utils.profiling import TRACER

SOURCE = REPO_ROOT / "native" / "pskbank.cpp"
PLANE_SOURCE = REPO_ROOT / "psk_soft_tpu_torch" / "csrc" / "planebank.cpp"
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


@load_once
def _load_split():
    path, _ = build_shared(PLANE_SOURCE, "planebank", ["g++"],
                           ["-O3", "-std=c++17", "-fPIC", "-shared"])
    lib = ctypes.CDLL(str(path))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn in (lib.psk_split_f32, lib.psk_split_i16):
        fn.argtypes, fn.restype = [vp, i64, i64, vp, vp], None
    return lib


class _Segment:
    """One (2, rows, C) buffer of the plane ring: the re plane, the im
    plane.  ``lease`` is the numpy array over ``buf`` that every array
    popped from it has as its base; the bank holds it while the segment is
    its tail or holds queued rows, and otherwise only ``ref``, a weak
    reference to it, which dies with the last popped array."""

    __slots__ = ("buf", "lease", "ref")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.take()

    def take(self) -> None:
        self.lease = self.buf.numpy()
        self.ref = weakref.ref(self.lease)

    def free(self) -> bool:
        return self.lease is None and self.ref() is None


class NativePlaneBank:
    """Lockstep multichannel ring that deframes to time-major re/im planes
    and pops views of them.

    Interleaved frames are already time-major across channels, so a push
    is one native stride-2 re/im split (``csrc/planebank.cpp``) into the
    ring's storage.  ``dtype`` selects the wire format: "f32" (complex64
    frames) or "i16" (int16 I/Q pairs, the REDHAWK dataShort wire, half the
    bytes; it pairs with kernel B1's int16 ingest,
    ``FullKernelBatchEngine(ingest_scale=...)``).

    Storage: segments of ``capacity_samples`` rows, each one (2, rows, C)
    buffer of the wire dtype, page-locked when the process has initialised
    CUDA at the time the segment is allocated (``torch.cuda.
    is_initialized()``) and pageable otherwise, so an upload of a popped
    plane is a direct DMA once CUDA is up and a CPU run never starts it.  A
    push lands whole in the tail segment when it fits there, else at the
    start of another segment.  A pop of rows that lie in one segment (every
    pop of the rows of one push) returns (n, C) views of them: no copy, no
    fresh memory.  A pop that spans two segments copies into one new
    buffer, page-locked likewise.  Counters ``psk.bank.pop_views``,
    ``psk.bank.pop_copies`` and ``psk.bank.segments_allocated`` of
    :data:`~psk_soft_tpu_torch.utils.profiling.TRACER` count them.

    A popped array is the caller's to keep: the bank never writes a row
    again while an array popped from its segment is alive, and reuses a
    segment only once it holds no queued row and every array popped from
    it has been released.  Queued rows (at most ``capacity_samples``) span
    at most 2 segments, so while the consumer keeps no more than its latest
    pop at most 3 segments are live (:meth:`segments`); a segment freed
    beyond that goes back to torch's allocator.  An upload with
    ``non_blocking=True`` must keep the popped array until it completes.

    One producer and one consumer may use the bank from two threads.
    """

    MAX_SEGMENTS = 3

    def __init__(self, channels: int, capacity_samples: int = 1 << 20,
                 dtype: str = "f32"):
        if dtype not in ("f32", "i16"):
            raise ValueError(f"dtype must be 'f32' or 'i16', got {dtype!r}")
        if int(channels) <= 0 or int(capacity_samples) <= 0:
            raise ValueError("channels and capacity_samples must be > 0")
        self.channels = int(channels)
        self.capacity = int(capacity_samples)
        self.dtype = dtype
        self._np_dtype = np.float32 if dtype == "f32" else np.int16
        self._torch_dtype = torch.float32 if dtype == "f32" else torch.int16
        lib = _load_split()
        self._split = lib.psk_split_f32 if dtype == "f32" \
            else lib.psk_split_i16
        self._cv = threading.Condition()
        self._segments: list[_Segment] = []
        self._tail: Optional[_Segment] = None
        self._tail_row = 0
        self._queue = collections.deque()   # [segment, start, stop] rows
        self._count = 0
        self._closed = False
        self._flush_pending = False
        self._stats = [0, 0, 0, 0]   # frames in, samples out, flushes, dropped

    def _buffer(self, rows: int) -> torch.Tensor:
        return torch.empty((2, rows, self.channels), dtype=self._torch_dtype,
                           pin_memory=torch.cuda.is_initialized())

    def _new_tail(self) -> None:
        """Move the tail to a free segment, or a new one.  A segment
        without queued rows is let go of (``lease`` None) when the tail
        leaves it, or when its last queued row is popped or dropped."""
        old = self._tail
        if old is not None and not (self._queue and self._queue[-1][0] is old):
            old.lease = None
        seg = next((s for s in self._segments if s.free()), None)
        if seg is None:
            seg = _Segment(self._buffer(self.capacity))
            self._segments.append(seg)
            TRACER.count("psk.bank.segments_allocated")
        else:
            seg.take()
        self._tail, self._tail_row = seg, 0
        self._trim()

    def _trim(self) -> None:
        """Let go of free segments beyond :attr:`MAX_SEGMENTS`."""
        excess = len(self._segments) - self.MAX_SEGMENTS
        for seg in [s for s in self._segments if s.free()][:max(excess, 0)]:
            self._segments.remove(seg)

    def _consume(self, k: int) -> None:
        """Advance the head of the queue by k rows."""
        head = self._queue[0]
        head[1] += k
        if head[1] == head[2]:
            self._queue.popleft()
            if head[0] is not self._tail:
                head[0].lease = None

    def push_interleaved(self, frames: np.ndarray) -> bool:
        """Push interleaved frames: complex64 ((n, C)) or flat pairs of the
        wire dtype, length 2*n*C.  Returns True on overflow flush."""
        arr = np.asarray(frames)
        if np.iscomplexobj(arr):
            if self.dtype != "f32":
                raise ValueError("i16 bank takes int16 I/Q pairs")
            arr = arr.astype(np.complex64, copy=False).view(np.float32)
        arr = np.ascontiguousarray(arr, self._np_dtype).ravel()
        frame = 2 * self.channels
        if arr.size % frame:
            raise ValueError(
                f"push must be whole frames of {self.channels} channels")
        n = arr.size // frame
        if n == 0:
            return False
        with self._cv:
            flushed = self._count + n > self.capacity
            if flushed:
                # Drop everything queued; a push larger than the whole ring
                # keeps its most recent capacity frames.
                st = self._stats
                st[3] += self._count
                for seg, _, _ in self._queue:
                    if seg is not self._tail:
                        seg.lease = None
                self._queue.clear()
                self._count = 0
                st[2] += 1
                self._flush_pending = True
                if n > self.capacity:
                    arr = arr[(n - self.capacity) * frame:]
                    st[3] += n - self.capacity
                    n = self.capacity
            if self._tail is None or self._tail_row + n > self.capacity:
                self._new_tail()
            seg, row = self._tail, self._tail_row
            item = seg.buf.element_size()
            base = seg.buf.data_ptr() + row * self.channels * item
            self._split(arr.ctypes.data, n, self.channels, base,
                        base + self.capacity * self.channels * item)
            self._tail_row = row + n
            q = self._queue
            if q and q[-1][0] is seg and q[-1][2] == row:
                q[-1][2] = row + n
            else:
                q.append([seg, row, row + n])
            self._count += n
            self._stats[0] += n
            self._cv.notify_all()
        return flushed

    def pop_planes(self, n: int, timeout: Optional[float] = None):
        """Blocking pop of ``(re, im, flushed)`` with (n, C) plane arrays of
        the wire dtype: views of the ring when the rows lie in one
        segment.  ``flushed`` reports (and clears) the overflow marker set
        since the last pop.  None on timeout, or when the bank is closed
        with fewer than n rows queued."""
        n = int(n)
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        timeout_ms = -1 if timeout is None else max(0, int(timeout * 1000))
        with self._cv:
            ready = lambda: self._count >= n or self._closed  # noqa: E731
            self._cv.wait_for(ready, None if timeout_ms < 0
                              else timeout_ms / 1000)
            if self._count < n:
                return None
            q = self._queue
            if n and q[0][2] - q[0][1] >= n:
                seg, start, _ = q[0]
                re, im = seg.lease[:, start:start + n]
                self._consume(n)
                TRACER.count("psk.bank.pop_views")
            else:
                re, im = self._buffer(n).numpy()
                got = 0
                while got < n:
                    seg, start, stop = q[0]
                    k = min(stop - start, n - got)
                    re[got:got + k] = seg.lease[0, start:start + k]
                    im[got:got + k] = seg.lease[1, start:start + k]
                    self._consume(k)
                    got += k
                TRACER.count("psk.bank.pop_copies")
            self._count -= n
            self._stats[1] += n
            flushed, self._flush_pending = self._flush_pending, False
        return re, im, flushed

    def close(self) -> None:
        """End of stream: wake blocked pops, which then take what is
        queued only if it covers their n."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def depth(self) -> int:
        with self._cv:
            return self._count

    def segments(self) -> int:
        """Segments the bank holds: its tail, those with queued rows,
        those with popped arrays alive, and free ones up to
        :attr:`MAX_SEGMENTS`."""
        with self._cv:
            self._trim()
            return len(self._segments)

    def stats(self) -> BankStats:
        with self._cv:
            return BankStats(*self._stats)
