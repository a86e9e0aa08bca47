"""ctypes bindings for the native C++ packet queue (port of
``psk_soft_tpu/runtime/native_queue.py:32-214`` over ``native/pskq.cpp``).

The queue is the host-side ingest stage of the streaming runtime: producers
(sockets, files, SDR frontends) push IQ packets from any thread; a feeder
thread pops (blocking, like ``getPacket(bulkio::Const::BLOCKING)``,
cpp/psk_soft.cpp:349) and drives a demod engine while the device overlaps
compute.  Overflow flushes the queue and flags the next packet, which the
engine answers with a full state reset (cpp/psk_soft.cpp:353-357).

The library is compiled from ``native/pskq.cpp`` with g++ into
``build/psk_soft_tpu_torch/`` at first use (the prebuilt ``.so`` in
``native/`` belongs to the JAX package and is not loaded).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import time
from typing import Optional

import numpy as np

from ..utils.build import REPO_ROOT, build_shared
from .streams import SRI, Packet

SOURCE = REPO_ROOT / "native" / "pskq.cpp"
# native/Makefile's flags for libpskq.so.
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread"]


@functools.lru_cache(maxsize=None)
def _load_lib():
    path, _ = build_shared(SOURCE, "pskq", ["g++"], CXX_FLAGS)
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_uint64)
    f32p, f64 = ctypes.POINTER(ctypes.c_float), ctypes.c_double
    lib.pskq_create.restype = vp
    lib.pskq_create.argtypes = [u64, u64]
    lib.pskq_destroy.argtypes = [vp]
    lib.pskq_push.restype = ctypes.c_int
    lib.pskq_push.argtypes = [vp, f32p, u64, f64, i32, i32, f64, i32,
                              ctypes.c_char_p]
    lib.pskq_peek.restype = i64
    lib.pskq_peek.argtypes = [vp, i64]
    lib.pskq_pop_into.restype = i64
    lib.pskq_pop_into.argtypes = [
        vp, f32p, u64, ctypes.POINTER(f64), ctypes.POINTER(i32),
        ctypes.POINTER(i32), ctypes.POINTER(f64), ctypes.POINTER(i32),
        ctypes.POINTER(i32), ctypes.c_char_p, u64]
    lib.pskq_close.argtypes = [vp]
    lib.pskq_stats.argtypes = [vp, ctypes.POINTER(u64)]
    lib.pskq_depth.restype = u64
    lib.pskq_depth.argtypes = [vp]
    return lib


@dataclasses.dataclass
class QueueStats:
    pushed: int
    popped: int
    flushes: int
    dropped_packets: int
    bytes_in: int
    bytes_out: int


class NativePacketQueue:
    """Bounded blocking packet queue with overflow-flush semantics."""

    def __init__(self, capacity_bytes: int = 64 << 20,
                 max_packets: int = 1024):
        self._lib = _load_lib()
        self._h = self._lib.pskq_create(capacity_bytes, max_packets)
        if not self._h:
            raise MemoryError("pskq_create failed")

    def push(self, data: np.ndarray, sri: SRI, t: float = 0.0,
             eos: bool = False, sri_changed: bool = False) -> bool:
        """Push interleaved-float or complex IQ; returns True if this push
        triggered an overflow flush."""
        arr = np.asarray(data)
        if np.iscomplexobj(arr):
            arr = arr.astype(np.complex64).view(np.float32)
        arr = np.ascontiguousarray(arr, np.float32).ravel()
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return bool(self._lib.pskq_push(
            self._h, ptr, arr.size, float(t), int(eos), int(sri_changed),
            float(sri.xdelta), int(sri.mode), sri.stream_id.encode()))

    def pop(self, timeout: Optional[float] = None) -> Optional[Packet]:
        """Blocking pop; returns None on timeout.  Complex-mode packets come
        back as complex64.

        A finite timeout is a deadline for the WHOLE call: re-peeks after a
        peek/pop race (head replaced by a concurrent producer or flush) wait
        only for the remaining time, so the caller's bound holds under
        producer churn."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is None:
                timeout_ms = -1
            else:
                timeout_ms = max(0, int((deadline - time.monotonic()) * 1000))
            n = self._lib.pskq_peek(self._h, timeout_ms)
            if n < 0:
                return None
            pkt = self._pop_exact(int(n))
            if pkt is not None:
                return pkt
            # Head changed between peek and pop (concurrent producer or
            # flush); re-peek with the remaining deadline.

    def _pop_exact(self, n: int) -> Optional[Packet]:
        buf = np.empty(n, np.float32)
        t = ctypes.c_double()
        eos = ctypes.c_int32()
        sric = ctypes.c_int32()
        xdelta = ctypes.c_double()
        mode = ctypes.c_int32()
        flushed = ctypes.c_int32()
        sid = ctypes.create_string_buffer(256)
        rc = self._lib.pskq_pop_into(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            buf.size, ctypes.byref(t), ctypes.byref(eos), ctypes.byref(sric),
            ctypes.byref(xdelta), ctypes.byref(mode), ctypes.byref(flushed),
            sid, len(sid))
        if rc in (-1, -2):
            # Head consumed by another consumer (-1) or replaced by a larger
            # packet (-2) between peek and pop; caller re-peeks.
            return None
        if rc < 0:
            raise RuntimeError(f"pskq_pop_into failed: {rc}")
        # rc is the ACTUAL float count copied; if the head shrank between
        # peek and pop (producer overflow-flush then push), trim -- never
        # deliver uninitialized tail floats into the demod.
        buf = buf[: int(rc)]
        data = buf.view(np.complex64) if mode.value == 1 else buf
        return Packet(
            data=data,
            sri=SRI(stream_id=sid.value.decode(), xdelta=xdelta.value,
                    mode=mode.value),
            t=t.value,
            eos=bool(eos.value),
            sri_changed=bool(sric.value),
            input_queue_flushed=bool(flushed.value),
        )

    def close(self) -> None:
        self._lib.pskq_close(self._h)

    def stats(self) -> QueueStats:
        out = (ctypes.c_uint64 * 6)()
        self._lib.pskq_stats(self._h, out)
        return QueueStats(*[int(v) for v in out])

    def depth(self) -> int:
        return int(self._lib.pskq_depth(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pskq_destroy(h)
            self._h = None


class FeedThread(threading.Thread):
    """Service thread: pops packets and drives a StreamEngine (or anything
    with its ``process(packet) -> {port: Packet}``), collecting output
    packets per port (the ThreadedComponent service loop equivalent,
    psk_soft_base.cpp:68-80).  An exception in the thread ends it and is
    raised again by ``join``."""

    def __init__(self, queue: NativePacketQueue, engine, sink=None,
                 poll_timeout: float = 0.1):
        super().__init__(daemon=True)
        self.queue = queue
        self.engine = engine
        self.sink = sink or (lambda outputs: None)
        self.poll_timeout = poll_timeout
        self.outputs: dict[str, list] = {}
        self._stop_evt = threading.Event()
        self.exception: Optional[BaseException] = None

    def run(self):
        try:
            while not self._stop_evt.is_set():
                pkt = self.queue.pop(timeout=self.poll_timeout)
                if pkt is None:
                    continue
                outs = self.engine.process(pkt)
                for port, p in outs.items():
                    self.outputs.setdefault(port, []).append(p)
                self.sink(outs)
                if pkt.eos:
                    break
        except BaseException as e:  # surfaced to the joiner
            self.exception = e

    def stop(self):
        self._stop_evt.set()

    def join(self, timeout=None):
        super().join(timeout)
        if self.exception is not None:
            raise self.exception
