"""Kernels B2 and B3 (ops/cuda/viterbi_kernel): the launch plan at its
edges, the fused kernel's envelope, B3's chunk carry contract and the
start-state rule of B2 on NaN metrics, on the CPU.

The plan is pure Python (``launch_plan``, the twin of ``make_plan`` in
csrc/viterbi.cu, which chip_smoke.py holds equal on the card).  The carry
and start-state tests run the plain versions, which the kernels equal bit
for bit on the card; the start rule is also held against the Pallas fused
kernel in interpret mode, where it differs (ROADMAP C).  Tolerances:
decisions, bits and start states equal; metrics equal (the same float
operations in the same order).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.ops.pallas import viterbi_kernel as jvk
from psk_soft_tpu_torch.ops import fec
from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

torch.set_num_threads(1)

KS = (2, 3, 7, 9, 10)
NS = tuple(range(1, 9))
BS = (1, 7, 31, 6144, 6145)
TS = (0, 1, 64, 1472, 4096 + 37)


def _limits_kept(plan, s_count, n, t, b, fused):
    lanes = min(32, s_count // 2)
    assert plan.lanes_per_row == lanes
    assert plan.rows_per_warp * lanes == 32
    assert plan.rows_per_block == plan.warps * plan.rows_per_warp
    assert plan.grid * plan.rows_per_block >= b
    assert (plan.grid - 1) * plan.rows_per_block < max(b, 1)
    assert plan.smem <= vk.SMEM_LIMIT
    assert 1 <= plan.chunk <= vk.MAX_CHUNK and plan.chunk <= max(t, 1)
    # The chunk shrinks only once the block is down to one warp.
    assert plan.warps == 1 or plan.chunk == min(vk.MAX_CHUNK, max(t, 1))
    if fused:
        assert plan.warps <= vk.FUSED_WARPS
        assert plan.rows_per_block <= max(vk.FUSED_MAX_ROWS,
                                          plan.rows_per_warp)
        assert plan.threads == 32 * plan.warps
    else:
        assert plan.warps <= vk.ACS_ROWS
        assert plan.threads == 32 * (plan.warps + vk.WRITER_WARPS)
    assert plan.threads <= 1024


@pytest.mark.parametrize("k", KS)
def test_launch_plan_edges(k):
    """Every (n, B, t) of the edges: B3 always plans, within every limit;
    B2 plans exactly when it takes the trellis, within every limit."""
    s_count = 1 << (k - 1)
    for n, b, t in itertools.product(NS, BS, TS):
        _limits_kept(vk.launch_plan(s_count, n, t, b, False),
                     s_count, n, t, b, False)
        if vk.fused_fits(s_count, t):
            _limits_kept(vk.launch_plan(s_count, n, t, b, True),
                         s_count, n, t, b, True)
        else:
            with pytest.raises(ValueError, match="over the fused kernel"):
                vk.launch_plan(s_count, n, t, b, True)


@pytest.mark.parametrize("k", KS)
def test_fused_fits_agrees_with_the_plan(k):
    """fused_fits holds exactly where B2's plan succeeds, at every n, and
    fused_smem_bytes is the plan's shared memory."""
    s_count = 1 << (k - 1)
    top = vk.fused_max_steps(s_count)
    for n, t in itertools.product(NS, TS + (32, 63, 65, 191, 704, 705,
                                            top, top + 1)):
        if vk.fused_fits(s_count, t):
            plan = vk.launch_plan(s_count, n, t, 5, True)
            assert vk.fused_smem_bytes(s_count, t, n) == plan.smem
        else:
            with pytest.raises(ValueError):
                vk.launch_plan(s_count, n, t, 5, True)


@pytest.mark.parametrize("k", KS)
def test_fused_envelope_plans_at_every_n(k):
    """B2 takes every trellis of up to 1472 steps for K <= 9 and 704 at
    K10, at every n and row count, within 48 KB: over the budget the plan
    halves the warps a block first, then the chunk."""
    s_count = 1 << (k - 1)
    top = 704 if k == 10 else 1472
    assert vk.fused_max_steps(s_count) == top
    for n, t in itertools.product(NS, range(top - 40, top + 1)):
        _limits_kept(vk.launch_plan(s_count, n, t, 6145, True),
                     s_count, n, t, 6145, True)
    assert not vk.fused_fits(s_count, top + 1)


def test_fused_limits_and_dispatch_paths():
    """The chain shape fits B2 with 8 warps a block; K7 at 2048 steps
    (phase 13 of chip_smoke.py) and K9 at 1500 steps take B3 + B4."""
    assert vk.fused_fits(64, 64) and vk.fused_fits(512, 64)
    assert vk.fused_fits(64, 1472) and not vk.fused_fits(64, 2048)
    assert not vk.fused_fits(256, 1500)
    plan = vk.launch_plan(64, 2, 64, 6144, True)
    assert (plan.warps, plan.rows_per_block, plan.chunk, plan.grid) == (
        8, 8, 64, 768)
    plan = vk.launch_plan(64, 2, 4096, 512, False)
    assert (plan.rows_per_block, plan.chunk, plan.grid, plan.threads) == (
        vk.ACS_ROWS, 64, 512 // vk.ACS_ROWS, 32 * (8 + vk.WRITER_WARPS))
    plan = vk.launch_plan(256, 8, 1472, 512, True)      # one warp, chunk 16
    assert (plan.warps, plan.chunk, plan.grid) == (1, 16, 512)


@pytest.mark.parametrize("args", [
    (3, 2, 64, 8, False), (1024, 2, 64, 8, False),
    (64, 0, 64, 8, False), (64, 9, 64, 8, False),
    (64, 2, -1, 8, False), (64, 2, 64, -1, False),
    (64, 2, 1473, 8, True), (512, 2, 705, 8, True),
    (256, 2, 1500, 8, True)])                # over the fused envelope
def test_launch_plan_refuses(args):
    with pytest.raises(ValueError):
        vk.launch_plan(*args)


def _planes(code, b, t_pad, seed):
    """Random LLRs and random start metrics (every state reachable)."""
    rng = np.random.default_rng(seed)
    llr = rng.standard_normal((code.n, t_pad, b)).astype(np.float32)
    pm0 = (10.0 * rng.standard_normal((code.states, b))).astype(np.float32)
    return (torch.from_numpy(llr), torch.from_numpy(pm0),
            torch.from_numpy(vk.butterfly_signs(code)))


@pytest.mark.parametrize("split", [0, 1, 17, 64, 100])
@pytest.mark.parametrize("name", ["k3", "k7", "k7r13"])
def test_acs_chunk_carry_contract(name, split):
    """Two viterbi_acs_ref calls with the metrics carried equal one call:
    decisions and final metrics exactly, t_actual 0 included (the
    streaming decoder of ROADMAP A.7 relies on it)."""
    code = {"k3": fec.CODE_K3, "k7": fec.CODE_K7,
            "k7r13": fec.ConvCode(7, (0o133, 0o165, 0o171))}[name]
    t = 100
    llr, pm0, exp = _planes(code, 9, t, seed=split)
    kw = dict(k=code.k, s_count=code.states, n=code.n)
    dec, pm = vk.viterbi_acs_ref(llr, pm0, exp, t_actual=t, **kw)
    dec1, pm1 = vk.viterbi_acs_ref(llr[:, :split].contiguous(), pm0, exp,
                                   t_actual=split, **kw)
    dec2, pm2 = vk.viterbi_acs_ref(llr[:, split:].contiguous(), pm1, exp,
                                   t_actual=t - split, **kw)
    assert torch.equal(torch.cat([dec1, dec2]), dec)
    assert torch.equal(pm2, pm)
    if split == 0:
        assert torch.equal(pm1, pm0)                # no step: pm0 as it is


def _first_nan_or_max(pm):
    """torch.argmax's rule: the first NaN, else the first maximum."""
    nan = torch.isnan(pm)
    first_nan = torch.argmax(nan.to(torch.int8), dim=0)
    first_max = torch.argmax(torch.where(nan, -torch.inf, pm), dim=0)
    return torch.where(nan.any(dim=0), first_nan, first_max)


@pytest.mark.parametrize("t_actual", [1, 3])
def test_fused_start_takes_the_first_nan(t_actual):
    """K7, terminate=False, NaN in pm0 rows 5 and 40: the plain version
    (and so kernel B2) starts the traceback at the first NaN of the final
    metrics, as torch.argmax does; the Pallas fused kernel compares with
    the NaN maximum, finds no equal state and starts from the out-of-range
    state S (recorded here: ROADMAP C)."""
    code, b, t_pad, s = fec.CODE_K7, 128, 32, 64
    llr, pm0, exp = _planes(code, b, t_pad, seed=t_actual)
    pm0[[5, 40]] = float("nan")
    kw = dict(k=7, s_count=s, n=2, t_actual=t_actual)
    decs, pm = vk._acs_steps(llr, pm0, exp, s, 2, t_actual)
    start = torch.argmax(pm, dim=0)
    assert torch.isnan(pm).any(dim=0).all()
    assert torch.equal(start, _first_nan_or_max(pm))
    assert torch.isnan(pm[start, torch.arange(b)]).all()
    bits = vk.viterbi_fused_ref(llr, pm0, exp, terminate=False, **kw)
    want = vk._walk_back(decs, start, k=7, s_count=s, t_actual=t_actual,
                         t_pad=t_pad)
    assert torch.equal(bits, want)

    # The Pallas kernel: the walk from state S, whose decision reads as 0.
    dec = torch.stack(decs).to(torch.int64)                  # (t, S, B)
    st = np.full(b, s, np.int64)
    pallas_want = np.zeros((t_pad, b), np.int8)
    for t in range(t_actual - 1, -1, -1):
        pallas_want[t] = (st >> 5) & 1
        p_bit = np.where(st < s, dec[t].numpy()[np.minimum(st, s - 1),
                                                np.arange(b)], 0)
        st = ((st << 1) & (s - 1)) | p_bit
    got = jvk.viterbi_fused(jnp.asarray(llr.numpy()),
                            jnp.asarray(pm0.numpy()),
                            jnp.asarray(jvk.butterfly_signs(jfec.CODE_K7)),
                            t_pad=t_pad, terminate=False, interpret=True,
                            **kw)
    np.testing.assert_array_equal(np.asarray(got), pallas_want)


def test_decode_planes_uploads_the_signs_once():
    """The butterfly signs are cached per (code, device): the chain's
    blocks reuse one plane."""
    x = torch.zeros((4, 2 * 70))
    a = vk.decode_planes(fec.CODE_K7, x)[2]
    b = vk.decode_planes(fec.CODE_K7, torch.ones((3, 2 * 70)))[2]
    assert a is b
    np.testing.assert_array_equal(a.numpy(), vk.butterfly_signs(fec.CODE_K7))
    assert vk.decode_planes(fec.CODE_K9, x)[2] is not a
