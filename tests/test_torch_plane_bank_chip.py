"""On the card: once CUDA is up, the plane bank's pops are page-locked,
the engine's upload of one is a pinned DMA, and the engine's outputs from
it equal, bit for bit, those from a pageable copy of the same planes.

Needs an NVIDIA GPU and no JAX; ``tests/conftest.py`` imports JAX, so run
it without the conftest::

    python3 -m pytest tests/test_torch_plane_bank_chip.py -m chip \\
        --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
from psk_soft_tpu_torch.runtime.streams import SRI

C, S, SPS = 1024, 512, 8
NEED = S * SPS
BLOCKS = 4
FULL_SCALE = 1.25
PINNED, PAGEABLE = "Memcpy HtoD (Pinned -> Device)", \
    "Memcpy HtoD (Pageable -> Device)"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda.init()


def _wire(dtype):
    """BLOCKS blocks of flat interleaved QPSK frames on rectangular pulses
    with a carrier offset a channel and noise, of the wire dtype."""
    rng = np.random.default_rng(2026)
    t = np.arange(BLOCKS * NEED)[:, None]
    sym = rng.integers(0, 4, (BLOCKS * S, C))
    x = np.repeat(np.exp(1j * (np.pi / 4 + np.pi / 2 * sym)), SPS, axis=0)
    x = x * np.exp(2j * np.pi * rng.uniform(-1e-4, 1e-4, C) * t)
    x = x + 0.01 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    pairs = np.stack([x.real, x.imag], axis=-1).reshape(BLOCKS, -1)
    if dtype == "f32":
        return pairs.astype(np.float32)
    return np.round(pairs * (32767 / FULL_SCALE)).astype(np.int16)


def _engine(dtype):
    i16 = dtype == "i16"
    eng = FullKernelBatchEngine(
        DemodConfig(sps=SPS, num_avg=100, constellation_size=4,
                    phase_avg=50),
        C, block_symbols=S, ingest_scale=FULL_SCALE / 32767 if i16 else None,
        soft_i8=i16, soft_i8_scale=100.0, debug_ports=True, device="cuda")
    eng.set_input_sri(SRI(stream_id="chip", xdelta=1e-6))
    return eng


def _copies(prof) -> dict:
    """The profiled host-to-device copies: {name: count}."""
    return {e.key: e.count for e in prof.key_averages()
            if "Memcpy HtoD" in e.key}


@pytest.mark.chip
@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_pops_are_page_locked(card, dtype):
    wire = _wire(dtype)
    bank = NativePlaneBank(C, capacity_samples=4 * NEED, dtype=dtype)
    bank.push_interleaved(wire[0])
    re, im, _ = bank.pop_planes(NEED, timeout=0)
    assert torch.from_numpy(re).is_pinned()
    assert torch.from_numpy(im).is_pinned()
    # A pop across two segments is a copy, page-locked too.
    bank.push_interleaved(wire[1])
    bank.push_interleaved(wire[2][:2 * C * (3 * NEED // 2)])
    bank.push_interleaved(wire[3])            # past the end: next segment
    bank.pop_planes(NEED, timeout=0)
    re, _, _ = bank.pop_planes(2 * NEED, timeout=0)
    assert torch.from_numpy(re).is_pinned()
    bank.close()


def _profiled_run(eng, planes):
    """Every block's packets, and the host-to-device copies of the last
    block, the profiler recording only that one (the blocks before warm it
    up, as the benchmark's traced stretch does)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=len(planes) - 1,
                                    active=1, repeat=1)
    packets = []
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for re, im in planes:
            eng.push_planes(re, im)
            packets.append(eng.step_packets())
            torch.cuda.synchronize()
            prof.step()
    assert eng.steady
    return packets, _copies(prof)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_engine_uploads_pops_by_pinned_dma(card, dtype):
    """Every block once from the bank's views and once from pageable
    copies of them: a steady block's upload is two pinned DMAs from the
    views and two pageable copies from the copies, and every port of
    every block is equal."""
    wire = _wire(dtype)
    bank = NativePlaneBank(C, capacity_samples=4 * NEED, dtype=dtype)
    views = []
    for b in range(BLOCKS):
        bank.push_interleaved(wire[b])
        views.append(bank.pop_planes(NEED, timeout=0)[:2])
    copies = [(np.array(re), np.array(im)) for re, im in views]
    got, from_views = _profiled_run(_engine(dtype), views)
    want, from_copies = _profiled_run(_engine(dtype), copies)
    assert from_views == {PINNED: 2}
    assert from_copies == {PAGEABLE: 2}
    assert [p is None for p in got] == [p is None for p in want]
    for g, w in zip(got, want):
        if g is not None:
            assert sorted(g) == sorted(w)
            for port in g:
                np.testing.assert_array_equal(g[port].data, w[port].data)
    bank.close()
