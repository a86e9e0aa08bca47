"""Kernel B4 (ops/cuda/viterbi_kernel.viterbi_traceback), on the CPU.

The kernel runs only on the card (chip_smoke.py phases 6c and 13 hold it
bit-equal to the plain version).  Here: (1) the plain version against the
Pallas ``viterbi_traceback`` (interpret mode) on the same random decision
planes, bits equal, for start states inside and outside [0, S); (2) the
launch plan ``traceback_plan`` at its edges, and the kernels' own check
of a plan (csrc/traceback_plan.h, built with the host compiler) taking
every plan the wrapper makes and refusing the others; (3) the composition
the kernels compute, emulated here with numpy: segments walked back from
every state, their maps chained from the start state, equal to the plain
version's bits.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu.ops.pallas import viterbi_kernel as jvk
from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

torch.set_num_threads(1)

B, T_PAD = 128, 32          # one Pallas row tile, one time tile
H100_SMEM = 232448          # opt-in shared memory a block, H100


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("t_actual", [0, 1, 20])
def test_plain_traceback_matches_pallas_for_every_start(k, t_actual):
    """Starts S, S + 5, -1, -7 and in-range ones, column by column: the
    first bit from the raw start (an arithmetic shift), decision 0 where
    the start lies outside [0, S)."""
    s_count = 1 << (k - 1)
    rng = np.random.default_rng(10 * k + t_actual)
    dec = rng.integers(0, 2, (T_PAD, s_count, B)).astype(np.int8)
    start = rng.integers(0, s_count, (1, B)).astype(np.int32)
    start[0, :4 * 8] = np.repeat([s_count, s_count + 5, -1, -7], 8)
    kw = dict(k=k, s_count=s_count, t_actual=t_actual)
    want = jvk.viterbi_traceback(jnp.asarray(dec), jnp.asarray(start),
                                 t_tile=T_PAD, interpret=True, **kw)
    vk.viterbi_traceback.launches = 0
    got = vk.viterbi_traceback(torch.from_numpy(dec), torch.from_numpy(start),
                               **kw)
    assert vk.viterbi_traceback.launches == 0           # CPU: plain
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[t_actual:].any()


def test_out_of_range_start_changes_only_what_the_rule_says():
    """From start S + 5 the walk equals the walk from its first successor
    ((start << 1) & (S-1)) | 0 one step later, with the raw start's bit."""
    s_count, k, t = 64, 7, 20
    rng = np.random.default_rng(3)
    dec = torch.from_numpy(rng.integers(0, 2, (t, s_count, 4)).astype(np.int8))
    raw = torch.tensor([[s_count + 5, -1, -7, s_count]], dtype=torch.int32)
    got = vk.viterbi_traceback(dec, raw, k=k, s_count=s_count, t_actual=t)
    nxt = ((raw.to(torch.int64) << 1) & (s_count - 1)).to(torch.int32)
    rest = vk.viterbi_traceback(dec[:t - 1].contiguous(), nxt, k=k,
                                s_count=s_count, t_actual=t - 1)
    assert torch.equal(got[:t - 1], rest)
    assert got[t - 1].tolist() == [((v >> (k - 2)) & 1)
                                   for v in raw[0].tolist()]


def _composed_walk(dec, start, k, t):
    """The two passes of csrc/viterbi.cu's B4 on (T_pad, S, B) decisions,
    sized by traceback_plan: each segment of the t - 1 steps before the
    last walked back from each of the S states (its bit words and the state
    it ends in), then per row the last step from the start, the segments'
    maps chained down, each word taken from the state entering its
    segment."""
    t_pad, s_count, b = dec.shape
    plan = vk.traceback_plan(s_count, b, t)
    steps, cols = max(t - 1, 0), np.arange(b)
    words = np.zeros((-(-steps // 32), s_count, b), np.uint32)
    fmap = np.zeros((plan.segments, s_count, b), np.int64)
    for seg in range(plan.segments):
        lo = seg * plan.seg_len
        st = np.repeat(np.arange(s_count)[:, None], b, 1)
        acc = np.zeros((s_count, b), np.uint32)
        for tt in range(min(lo + plan.seg_len, steps) - 1, lo - 1, -1):
            d = np.take_along_axis(dec[tt], st, 0) != 0
            acc |= ((st >> (k - 2)) & 1).astype(np.uint32) << (tt & 31)
            st = ((st << 1) & (s_count - 1)) | d
            if tt & 31 == 0:
                words[tt >> 5], acc = acc, np.zeros_like(acc)
        fmap[seg] = st
    bits = np.zeros((t_pad, b), np.int8)
    if t == 0:
        return bits
    raw = start[0].astype(np.int64)
    bits[t - 1] = (raw >> (k - 2)) & 1
    inside = (raw >= 0) & (raw < s_count)
    d = inside & (dec[t - 1][np.clip(raw, 0, s_count - 1), cols] != 0)
    e, enter = ((raw << 1) & (s_count - 1)) | d, {}
    for seg in range(plan.segments - 1, -1, -1):
        enter[seg], e = e, fmap[seg][e, cols]
    for w in range(words.shape[0]):
        word = words[w][enter[32 * w // plan.seg_len], cols]
        for tt in range(32 * w, min(32 * w + 32, steps)):
            bits[tt] = (word >> (tt & 31)) & 1
    return bits


@pytest.mark.parametrize("k,b,t_pad,t", [
    (7, 300, 400, 333), (3, 50, 70, 65), (9, 40, 200, 130), (7, 20, 5, 1),
    (7, 20, 5, 2), (2, 9, 100, 97)])
def test_segment_composition_equals_the_plain_walk(k, b, t_pad, t):
    s_count = 1 << (k - 1)
    rng = np.random.default_rng(k * t)
    dec = rng.integers(0, 2, (t_pad, s_count, b)).astype(np.int8)
    start = rng.integers(-10, s_count + 10, (1, b)).astype(np.int32)
    want = vk.viterbi_traceback(torch.from_numpy(dec),
                                torch.from_numpy(start), k=k,
                                s_count=s_count, t_actual=t)
    np.testing.assert_array_equal(_composed_walk(dec, start, k, t),
                                  want.numpy())


@pytest.mark.parametrize("k", range(2, 11))
def test_traceback_plan_edges(k):
    """Shared memory within an H100 block's 227 KB, the segments covering
    the t_actual - 1 steps before the last, copies no wider than B's and
    the address's alignment, walks a thread within the kernel's register
    arrays; and the kernel's own check takes it."""
    s_count = 1 << (k - 1)
    check = vk.load_plan_check()
    for b, t, align in itertools.product((1, 6144, 6145, 512, 32),
                                         (0, 1, 2, 37, 4133), (16, 4, 2)):
        p = vk.traceback_plan(s_count, b, t, align)
        assert p.smem == vk.TB_BUFFERS * p.chunk * s_count * vk.TB_ROWS
        assert p.smem <= H100_SMEM
        steps = max(t - 1, 0)
        assert p.seg_len % 32 == 0 and p.seg_len >= vk.TB_MIN_SEGMENT
        assert p.segments * p.seg_len >= steps > (p.segments - 1) * p.seg_len
        assert p.segments <= vk.TB_MAX_SEGMENTS
        groups = -(-b // vk.TB_ROWS)
        assert p.grid == groups * p.segments
        assert b % p.vec == 0 and align % p.vec == 0
        assert p.vec == (16 if b % 16 == 0 and align == 16 else
                         4 if b % 4 == 0 and align % 4 == 0 else 1)
        assert 1 <= p.chunk <= vk.TB_MAX_CHUNK
        walk_warps = p.threads // 32 - vk.TB_COPY_WARPS
        assert walk_warps == min(s_count, vk.TB_WALK_WARPS)
        assert s_count // walk_warps <= 32          # the kernels' largest Q
        assert check(s_count, t, b, *p) == 0, (b, t, align, p)


def test_traceback_plan_flagship_numbers():
    """The shapes chip_smoke.py and tools/kernel_times.py time: K7 512 x
    4096 in 16 segments of 256 steps (256 blocks), 12-step tiles of 24 KB,
    four of them, 16-byte copies, 16 walker warps of 4 walks; K9 256 x 1024
    in 16 segments of 64 steps; 32 rows x 2048 steps in 32 segments."""
    assert tuple(vk.traceback_plan(64, 512, 4096)) == (
        16, 12, 256, 16, 4 * 12 * 64 * 32, 256, 32 * 19)
    assert vk.traceback_plan(256, 256, 1024)[:5] == (16, 3, 64, 16, 98304)
    assert vk.traceback_plan(64, 32, 2048)[1:4] == (12, 64, 32)


@pytest.mark.parametrize("field,value", [
    ("vec", 8), ("vec", 16), ("chunk", 0),
    ("seg_len", 100), ("seg_len", 64), ("segments", 31), ("smem", 1),
    ("grid", 255), ("threads", 64)])
def test_kernel_refuses_a_plan_it_did_not_expect(field, value):
    """The C side's check refuses a plan off in any one field (a 16-byte
    copy for B = 6148, which is a multiple of 4 only, included)."""
    check = vk.load_plan_check()
    b = 6148 if (field, value) == ("vec", 16) else 512
    plan = vk.traceback_plan(64, b, 4096)._asdict()
    assert check(64, 4096, b, *plan.values()) == 0
    plan[field] = value
    assert check(64, 4096, b, *plan.values()) == 1
    assert check(63, 4096, b, *vk.traceback_plan(64, b, 4096)) == 1
    with pytest.raises(ValueError):
        vk.traceback_plan(63, b, 4096)
