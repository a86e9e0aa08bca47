"""The port's plane bank (``runtime/native_bank.NativePlaneBank``) on the
CPU, where its segments are pageable: what it pops equals, bit for bit,
what the JAX package's ring (``native/pskbank.cpp``) pops over the same
pushes and pops, and its own contract holds: a popped array is the
caller's to keep, a pop inside one segment is a view and one across two a
copy, and the live segments stay within the stated bound."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from psk_soft_tpu.runtime.native_bank import NativePlaneBank as JaxPlaneBank
from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
from psk_soft_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(1)

C = 5


def _frames(rng, n, dtype):
    """n interleaved frames of C channels, flat, of the wire dtype."""
    if dtype == "f32":
        return rng.standard_normal(2 * n * C).astype(np.float32)
    return rng.integers(-32768, 32768, 2 * n * C).astype(np.int16)


def _split(flat):
    """The (n, C) re and im planes of flat interleaved frames."""
    pairs = flat.reshape(-1, C, 2)
    return pairs[..., 0], pairs[..., 1]


@pytest.fixture
def counters():
    TRACER.reset()
    TRACER.enable()
    try:
        yield lambda: {k.rsplit(".", 1)[1]: v
                       for k, v in TRACER.snapshot()["counters"].items()
                       if k.startswith("psk.bank.")}
    finally:
        TRACER.disable()
        TRACER.reset()


@pytest.mark.parametrize("dtype", ["f32", "i16"])
@pytest.mark.parametrize("seed", range(6))
def test_pops_equal_the_jax_bank(dtype, seed):
    """Random push and pop sizes, overflow flushes among them, then close:
    every result, depth and statistic as the JAX package's ring, and every
    popped array held to the end unchanged."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(8, 40))
    ours = NativePlaneBank(C, capacity_samples=cap, dtype=dtype)
    ref = JaxPlaneBank(C, capacity_samples=cap, dtype=dtype)
    held = []
    for _ in range(200):
        if rng.random() < 0.5:
            flat = _frames(rng, int(rng.integers(0, cap + 6)), dtype)
            assert ours.push_interleaved(flat) == ref.push_interleaved(flat)
        else:
            n = int(rng.integers(0, cap + 2))
            got, want = ours.pop_planes(n, timeout=0), \
                ref.pop_planes(n, timeout=0)
            assert (got is None) == (want is None)
            if got is not None:
                assert got[2] == want[2]
                for a, b in zip(got[:2], want[:2]):
                    assert a.dtype == b.dtype and a.shape == (n, C)
                    np.testing.assert_array_equal(a, b)
                held.append((got[0], got[1], want[0], want[1]))
        assert ours.depth() == ref.depth()
        assert dataclasses.astuple(ours.stats()) == \
            dataclasses.astuple(ref.stats())
    ours.close()
    ref.close()
    for n in (ours.depth() + 1, ours.depth()):
        got, want = ours.pop_planes(n), ref.pop_planes(n)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert ours.stats().flushes > 0
    for re, im, want_re, want_im in held:
        np.testing.assert_array_equal(re, want_re)
        np.testing.assert_array_equal(im, want_im)


@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_overflow_flushes_and_flags_the_next_pop(dtype):
    rng = np.random.default_rng(3)
    bank = NativePlaneBank(C, capacity_samples=8, dtype=dtype)
    assert not bank.push_interleaved(_frames(rng, 6, dtype))
    assert bank.push_interleaved(_frames(rng, 4, dtype))   # 10 > 8
    assert bank.depth() == 4
    big = _frames(rng, 11, dtype)
    assert bank.push_interleaved(big)     # larger than the ring: last 8
    re, im, flushed = bank.pop_planes(8, timeout=0)
    assert flushed
    want_re, want_im = _split(big[3 * 2 * C:])
    np.testing.assert_array_equal(re, want_re)
    np.testing.assert_array_equal(im, want_im)
    assert bank.pop_planes(1, timeout=0) is None
    s = bank.stats()
    assert (s.frames_in, s.samples_out, s.flushes, s.dropped_samples) == \
        (6 + 4 + 8, 8, 2, 6 + 4 + 3)


def test_close_wakes_a_blocked_pop():
    bank = NativePlaneBank(C, capacity_samples=16)
    bank.push_interleaved(_frames(np.random.default_rng(0), 3, "f32"))
    out = []
    t = threading.Thread(target=lambda: out.append(bank.pop_planes(4)))
    t.start()
    t.join(0.2)
    assert t.is_alive()
    bank.close()
    t.join(5)
    assert not t.is_alive() and out == [None]
    assert bank.pop_planes(3, timeout=None)[0].shape == (3, C)


def test_timeout_returns_none():
    bank = NativePlaneBank(C, capacity_samples=16)
    assert bank.pop_planes(1, timeout=0.05) is None
    assert bank.pop_planes(0, timeout=0)[0].shape == (0, C)


@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_threaded_producer_blocking_pops(dtype):
    """A producer thread pushes a stream in random sizes while the
    consumer pops fixed-size blocks with blocking waits; both banks give
    the stream's planes in order."""
    rng = np.random.default_rng(11)
    stream = _frames(rng, 3000, dtype)
    sizes = rng.integers(1, 97, 200)
    want_re, want_im = _split(stream)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for bank in (NativePlaneBank(C, 3000, dtype),
                     JaxPlaneBank(C, 3000, dtype)):
            def produce():
                k = 0
                for n in sizes:
                    bank.push_interleaved(stream[2 * C * k:2 * C * (k + n)])
                    k += n
                    if k >= 3000:
                        break

            t = threading.Thread(target=produce)
            t.start()
            got = []
            for _ in range(3000 // 60):
                r = bank.pop_planes(60, timeout=10)
                assert r is not None and not r[2]
                got.append(r[:2])
            t.join(10)
            assert not t.is_alive()
            np.testing.assert_array_equal(
                np.concatenate([g[0] for g in got]), want_re)
            np.testing.assert_array_equal(
                np.concatenate([g[1] for g in got]), want_im)
            assert bank.stats().flushes == 0
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_a_held_view_outlives_further_traffic(dtype, counters):
    """A popped view is not written again while it is held: more than
    3 x capacity further rows pushed and popped leave it as it was."""
    rng = np.random.default_rng(5)
    cap, n = 32, 8
    bank = NativePlaneBank(C, capacity_samples=cap, dtype=dtype)
    first = _frames(rng, n, dtype)
    bank.push_interleaved(first)
    re, im, _ = bank.pop_planes(n, timeout=0)
    assert counters()["pop_views"] == 1
    for _ in range(3 * cap // n + 2):
        flat = _frames(rng, n, dtype)
        bank.push_interleaved(flat)
        got = bank.pop_planes(n, timeout=0)
        np.testing.assert_array_equal(got[0], _split(flat)[0])
        del got
    want_re, want_im = _split(first)
    np.testing.assert_array_equal(re, want_re)
    np.testing.assert_array_equal(im, want_im)
    assert counters() == {"pop_views": 3 * cap // n + 3,
                          "segments_allocated": 2}


def test_views_share_the_ring_and_copies_do_not(counters):
    """Rows of one push pop as a view of its segment; rows split over two
    segments pop as a copy equal to the rows pushed."""
    rng = np.random.default_rng(9)
    bank = NativePlaneBank(C, capacity_samples=8)
    a, b = _frames(rng, 6, "f32"), _frames(rng, 4, "f32")
    bank.push_interleaved(a)
    re, im, _ = bank.pop_planes(3, timeout=0)
    assert re.base is im.base is not None
    bank.push_interleaved(b)           # 6 + 4 > 8 rows: another segment
    re2, im2, _ = bank.pop_planes(7, timeout=0)
    assert not np.shares_memory(re2, re)
    assert re2.flags.c_contiguous and im2.flags.c_contiguous
    want = _split(np.concatenate([a[3 * 2 * C:], b]))
    np.testing.assert_array_equal(re2, want[0])
    np.testing.assert_array_equal(im2, want[1])
    assert counters() == {"pop_views": 1, "pop_copies": 1,
                          "segments_allocated": 2}


def test_pops_of_whole_pushes_are_views(counters):
    """The harness's pattern: push a block, pop a block, release it.  One
    segment serves every block; every pop is a view."""
    rng = np.random.default_rng(2)
    bank = NativePlaneBank(C, capacity_samples=4 * 16)
    for _ in range(40):
        flat = _frames(rng, 16, "f32")
        bank.push_interleaved(flat)
        re, im, _ = bank.pop_planes(16, timeout=0)
        np.testing.assert_array_equal(im, _split(flat)[1])
        del re, im
    assert bank.segments() == 1
    assert counters() == {"pop_views": 40, "segments_allocated": 1}


@pytest.mark.parametrize("seed", range(4))
def test_live_segments_stay_within_the_bound(seed):
    """While the consumer keeps no more than its latest pop, the bank
    holds at most MAX_SEGMENTS (3) segments, and it lets go of the ones a
    consumer held once they are released."""
    rng = np.random.default_rng(seed)
    cap = 24
    bank = NativePlaneBank(C, capacity_samples=cap)
    latest = None
    for _ in range(300):
        if rng.random() < 0.55:
            bank.push_interleaved(_frames(rng, int(rng.integers(1, cap)),
                                          "f32"))
        else:
            latest = bank.pop_planes(int(rng.integers(1, cap)), timeout=0) \
                or latest
        assert bank.segments() <= NativePlaneBank.MAX_SEGMENTS
    kept = []
    for _ in range(12):
        bank.push_interleaved(_frames(rng, cap, "f32"))
        kept.append(bank.pop_planes(cap, timeout=0))
    assert bank.segments() >= 12
    del kept, latest
    assert bank.segments() <= NativePlaneBank.MAX_SEGMENTS


def test_segments_are_page_locked_once_cuda_is_up(monkeypatch):
    """Segments and straddling copies ask for page-locked memory exactly
    when the process has initialised CUDA; a CPU run never starts it."""
    asked = []
    empty = torch.empty

    def recording_empty(*shape, pin_memory=False, **kw):
        asked.append(pin_memory)
        return empty(*shape, **kw)

    bank = NativePlaneBank(C, capacity_samples=8)
    monkeypatch.setattr(torch, "empty", recording_empty)
    rng = np.random.default_rng(1)
    bank.push_interleaved(_frames(rng, 6, "f32"))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert bank.pop_planes(2, timeout=0) is not None
    bank.push_interleaved(_frames(rng, 4, "f32"))  # 6 + 4 rows: a new segment
    assert bank.pop_planes(8, timeout=0) is not None   # across two: a copy
    assert asked == [False, True, True]
    monkeypatch.undo()
    assert not torch.cuda.is_initialized()


def test_bad_arguments():
    with pytest.raises(ValueError):
        NativePlaneBank(C, dtype="f64")
    with pytest.raises(ValueError):
        NativePlaneBank(0)
    bank = NativePlaneBank(C, capacity_samples=8, dtype="i16")
    with pytest.raises(ValueError):
        bank.push_interleaved(np.zeros(3, np.complex64))
    with pytest.raises(ValueError):
        bank.push_interleaved(np.zeros(2 * C + 1, np.int16))
    with pytest.raises(ValueError):
        bank.pop_planes(-1)
