"""The port never imports jax or psk_soft_tpu: a fresh interpreter with both
blocked in sys.modules imports every module of psk_soft_tpu_torch and runs
one CPU engine step, a configure, a checkpoint round trip, a fused step,
CPU ChainEngine warm-up and steady steps, plain and acquire_cfo, the
exact-scan top-level names on a golden vector, a CPU StreamEngine in both
pipelines through EOS, a GroupEngine step, build_receiver(engine="full")
with frame sync, FEC, descrambling and CRC through a flush, the same
with the AGC, equalizer, carrier acquisition and quality tap fed from a
NativeChannelBank, an EqState checkpoint round trip, a streaming-FEC
step and flush, and the input side: a wideband capture through
ChannelizerFrontEnd into FullKernelBatchEngine, ResampledBankEngine, the
blind probe, and a FeedThread on a NativePacketQueue; then the TX and
evaluation layer: the CLI's selftest and baseline, measure_ber,
measure_coded_ber, measure_chain_fer and the scanned factories; then the
CLI's gen-frames into demod-batch with frame sync and FEC, every example
module imported, and the sharding layer: a sharded demod step on a 2 x 2
mesh of CPU shards and a DistributedBatchEngine step in one process."""

import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

PROGRAM = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "psk_soft_tpu"):
    sys.modules[name] = None          # any import of them raises
import numpy as np
import torch
torch.set_num_threads(1)
import psk_soft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(psk_soft_tpu_torch.__path__,
                                               "psk_soft_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
cfg = DemodConfig(sps=4, num_avg=10, constellation_size=4, phase_avg=12)
eng = FullKernelBatchEngine(cfg, 128, block_symbols=64, device="cpu")
rng = np.random.default_rng(0)
for _ in range(2):
    x = rng.standard_normal((64 * 4, 128)).astype(np.float32)
    eng.push_planes(x, x[::-1].copy())
    pkts = eng.step_packets()
assert eng.steady and pkts["softDecision_dataFloat_out"].data.shape == (128, 64)
import os, tempfile
from psk_soft_tpu_torch.utils.checkpoint import load_state, save_state
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "full.npz")
    save_state(path, eng.full_state, cfg)
    st, cfg2, _ = load_state(path, "cpu")
assert cfg2 == cfg and torch.equal(st.planes, eng.full_state.planes)
eng.restore_full_state(st)
eng.configure(DemodConfig(sps=4, num_avg=12, constellation_size=4,
                          phase_avg=12))
eng.push_planes(x, x[::-1].copy())
assert eng.step_packets() and eng.metrics.reconfigures == 1
from psk_soft_tpu_torch.models.fused import fused_init, make_fused_demod_fn
fst, fout = make_fused_demod_fn(cfg)(fused_init(cfg, 128, "cpu"),
                                     torch.from_numpy(x), torch.from_numpy(x))
assert fout.soft.shape == (128, 64) and int(fst.seen) == 10
from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
from psk_soft_tpu_torch.ops.fec import CODE_K7
from psk_soft_tpu_torch.ops.framesync import FrameFormat
from psk_soft_tpu_torch.runtime.chain_engine import ChainEngine
fmt = FrameFormat(uw=(0, 1, 2, 3) * 4, payload=32, m=4)
chain = ChainEngine(cfg, 128, fmt, CODE_K7, CRC16_CCITT, block_symbols=64,
                    device="cpu")
for _ in range(2):
    x = rng.standard_normal((64 * 4, 128)).astype(np.float32)
    chain.push_planes(x, x[::-1].copy())
    assert isinstance(chain.step(), list)
assert chain.chain_state is not None and chain.warmup_symbols == 64
acq = ChainEngine(cfg, 128, fmt, CODE_K7, CRC16_CCITT, block_symbols=64,
                  acquire_cfo=True, device="cpu")
for _ in range(2):
    x = rng.standard_normal((64 * 4, 128)).astype(np.float32)
    acq.push_planes(x, x[::-1].copy())
    assert isinstance(acq.step(), list)
assert acq.cfo_estimates.shape == (128,)
from psk_soft_tpu_torch import (DemodOutputs, DemodState, demod_block,
                                demod_init, init_state, make_demod_fn,
                                reconfigure)
from psk_soft_tpu_torch.runtime.engine import (BatchEngine, GroupEngine,
                                               StreamEngine, StreamRegistry)
from psk_soft_tpu_torch.runtime.streams import SRI, Packet
from psk_soft_tpu_torch.testing.oracle import demod_reference
from psk_soft_tpu_torch.testing.signals import gen_psk
gx, _ = gen_psk(300, 8, 4)
gcfg = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
gst, gout = make_demod_fn(gcfg)(demod_init(gcfg, device="cpu"), gx)
assert isinstance(gst, DemodState) and isinstance(gout, DemodOutputs)
assert int(gout.valid.sum()) == 201
assert demod_reference(gx, 8, 100, 4, 50)["soft"].size == 201
gst = reconfigure(gcfg, DemodConfig(sps=8, num_avg=100, constellation_size=4,
                                    phase_avg=20), gst)
assert int(gst.ring_fill) == 20
for pipeline in ("ff", "exact"):
    se = StreamEngine(gcfg, 128, pipeline, device="cpu")
    outs = [se.process(Packet(data=gx[i:i + 800], sri=SRI("s"),
                              eos=i + 800 >= gx.size))
            for i in range(0, gx.size, 800)]
    assert all(p.eos for p in outs[-1].values())
    assert se.metrics.symbols_out == 201 and se.metrics.eos_seen == 1
ge = GroupEngine([cfg, gcfg, cfg], block_symbols=64, device="cpu")
for ch, c in enumerate([cfg, gcfg, cfg]):
    ge.push(ch, gx[:64 * c.sps])
assert sorted(ge.step_all()) == [0, 1, 2]
from psk_soft_tpu_torch.ops import fec as tfec
from psk_soft_tpu_torch.ops.scramble import prbs15
from psk_soft_tpu_torch.runtime.receiver import build_receiver
rx = build_receiver(cfg, 128, engine="full", block_symbols=64,
                    uw=(0, 1, 2, 3) * 4, frame_payload=32, fec=CODE_K7,
                    fec_labeling="gray", descramble=prbs15(),
                    crc=CRC16_CCITT, device="cpu")
assert rx.syncer._tap_device
for _ in range(3):
    x = rng.standard_normal((64 * 4, 128)).astype(np.float32)
    rx.engine.push_planes(x, x[::-1].copy())
    rx.engine.step_packets()
rx.engine.flush_packets()
assert isinstance(rx.pop_frames(), list) and rx.steady
from psk_soft_tpu_torch.ops.equalizer import EqConfig, EqState
from psk_soft_tpu_torch.runtime.native_bank import NativeChannelBank
front = build_receiver(cfg, 128, engine="full", block_symbols=64, agc=True,
                       equalize=EqConfig(taps=9, mu=1e-4), acquire_cfo=True,
                       quality=True, uw=(0, 1, 2, 3) * 4, frame_payload=32,
                       fec=CODE_K7, fec_labeling="gray", crc=CRC16_CCITT,
                       device="cpu")
cbank = NativeChannelBank(128, capacity_samples=4096)
for _ in range(18):                   # acquisition at 4096 samples
    cbank.push_interleaved(rng.standard_normal((64 * 4, 256)).astype(
        np.float32))
    front.engine.push_planes(*(torch.from_numpy(np.ascontiguousarray(p.T))
                               for p in (lambda b: (b.real, b.imag))(
                                   cbank.pop_block(64 * 4)[0])))
    while front.engine.ready():
        front.engine.step_packets()
front.engine.flush_packets()
assert front.steady and front.cfo.shape == (128,)
assert front.quality.snapshot()["symbols"].sum() > 0
eqs = front.syncer.engine.engine.engine._state
with tempfile.TemporaryDirectory() as tmp:
    save_state(os.path.join(tmp, "eq.npz"), eqs, cfg)
    eq2, _, _ = load_state(os.path.join(tmp, "eq.npz"), "cpu")
assert isinstance(eq2, EqState) and torch.equal(eq2.w, eqs.w)
vs = tfec.viterbi_stream_init(CODE_K7, 4, 40, device="cpu")
vs, vb = tfec.make_stream_soft_fn(CODE_K7, 4)(
    vs, torch.complex(torch.randn(4, 32), torch.randn(4, 32)))
assert vb.shape == (4, 32) and tfec.viterbi_stream_flush(
    CODE_K7, vs).shape == (4, 40)
from psk_soft_tpu_torch.ops.channelizer import prototype_taps
from psk_soft_tpu_torch.ops.probe import classify_psk, estimate_baud
from psk_soft_tpu_torch.runtime.channelizer import ChannelizerFrontEnd
from psk_soft_tpu_torch.runtime.native_queue import (FeedThread,
                                                     NativePacketQueue)
from psk_soft_tpu_torch.runtime.resampler import ResampledBankEngine
from psk_soft_tpu_torch.testing.wideband import rc_psk, synthesize
wx, _ = rc_psk(np.full(128, 4.0), 64 * 4 * 2, 4, rng)
wide, _ = synthesize(wx.T, prototype_taps(128, 8))
fe = ChannelizerFrontEnd(128, device="cpu")
ceng = FullKernelBatchEngine(cfg, 128, block_symbols=64, device="cpu")
fe.push(wide)
while fe.available_rows() >= 64 * 4:
    ceng.push_planes(*fe.step_planes(64 * 4))
    ceng.step_packets()
assert ceng.steady
reng = ResampledBankEngine(cfg, 128, [4.4, 4.0] * 64, block_symbols=64,
                           device="cpu")
nx, _ = rc_psk(np.array([4.4, 4.0] * 64), 64 * 5 * 2, 4, rng, offset=3.0)
for ch in range(128):
    reng.push(ch, nx[ch])
assert reng.step_packets() is not None and isinstance(reng.flush_packets(),
                                                      list)
px = np.repeat(np.exp(2j * np.pi * rng.integers(0, 4, (4, 500)) / 4), 4,
               axis=1).astype(np.complex64)
sps_est, _ = estimate_baud(px, sps_min=2, sps_max=16, device="cpu")
assert np.abs(sps_est - 4.0).max() < 0.05
assert classify_psk(px, device="cpu")[0].tolist() == [4] * 4
q = NativePacketQueue()
feeder = FeedThread(q, StreamEngine(gcfg, 128, "ff", device="cpu"))
feeder.start()
for i in range(0, gx.size, 800):
    q.push(gx[i:i + 800], SRI("q"), eos=i + 800 >= gx.size)
feeder.join(timeout=60)
assert not feeder.is_alive() and q.stats().popped == -(-gx.size // 800)
assert sum(p.data.size for p in feeder.outputs[
    "softDecision_dataFloat_out"]) == 201
from psk_soft_tpu_torch import cli
from psk_soft_tpu_torch.eval.baseline_configs import run_config
from psk_soft_tpu_torch.eval.ber import measure_ber
from psk_soft_tpu_torch.eval.coded import measure_chain_fer, measure_coded_ber
from psk_soft_tpu_torch.models import blockpsk as tblockpsk, full as tfull
from psk_soft_tpu_torch.utils.transfer import to_device, to_host
assert cli.main(["selftest", "--device", "cpu"]) == 0
assert cli.main(["baseline", "--config", "4", "--device", "cpu"]) == 0
assert measure_ber(gcfg, 12.0, num_symbols=2000, device="cpu").n_symbols > 0
assert measure_coded_ber(CODE_K7, 4, 3.0, num_bits=2000,
                         device="cpu").n_frames == 2
assert measure_chain_fer(cfg, fmt, CODE_K7, CRC16_CCITT, 12.0, channels=128,
                         blocks=1, rows=(20, 120), device="cpu").frames == 256
sst, sout = tfull.make_scanned_full_demod_fn(cfg)(
    tfull.full_from_ff(cfg, tblockpsk.ff_init(cfg, 128, "cpu")),
    *(torch.from_numpy(rng.standard_normal((2, 64 * 4, 128)).astype(
        np.float32)) for _ in range(2)))
assert sout.soft_re.shape == (2, 64, 128)
fst, fout = tblockpsk.make_scanned_ff_demod_fn(cfg)(
    tblockpsk.ff_init(cfg, device="cpu"), to_device(gx[:2 * 256], "cpu")
    .reshape(2, 256))
assert to_host(fout).soft.shape == (2, 64)
assert {f"psk_soft_tpu_torch.examples.{n}" for n in (
    "bank_demod", "coded_link", "frame_sync", "hetero_rate_bank",
    "one_launch_chain", "sharded_mesh", "stream_demod",
    "wideband_bank")} <= set(names)
from psk_soft_tpu_torch.parallel.mesh import make_mesh
from psk_soft_tpu_torch.parallel.sharded import make_sharded_demod
from psk_soft_tpu_torch.runtime.distributed import DistributedBatchEngine
sout = make_sharded_demod(gcfg, make_mesh(2, 2, ["cpu"] * 4), 300)(
    torch.from_numpy(np.tile(gx, (4, 1))))
assert sout.soft.shape == (4, 300) and int(sout.valid.sum()) == 4 * 201
deng = DistributedBatchEngine(cfg, 128, mesh=make_mesh(4, devices=["cpu"] * 4),
                              block_symbols=64)
deng.push_block((rng.standard_normal((128, 256))
                 + 0j).astype(np.complex64))
assert deng.step_packets() and (deng.local_offset, deng.channels) == (0, 128)
with tempfile.TemporaryDirectory() as tmp:
    cap, rx = os.path.join(tmp, "cap.cf32"), os.path.join(tmp, "rx")
    uw = "0,1,2,3,3,2,1,0,0,2,1,3,1,1,2,2,3,0,2,1,1,3,0,2,2,0,3,1,0,3,1,2"
    assert cli.main(["gen-frames", "--out", cap, "--channels", "2",
                     "--symbols", "1200", "--uw", uw, "--frame-payload",
                     "64", "--fec", "k7", "--frame-interval", "300",
                     "--seed", "2"]) == 0
    assert cli.main(["demod-batch", "--in", cap, "--channels", "2",
                     "--out-prefix", rx, "--sps", "8", "-M", "4",
                     "--num-avg", "20", "--phase-avg", "20",
                     "--block-symbols", "256", "--uw", uw,
                     "--frame-payload", "64", "--fec", "k7",
                     "--device", "cpu"]) == 0
    assert len(open(rx + ".frames.jsonl").read().splitlines()) >= 4
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "psk_soft_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", PROGRAM], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert line.startswith("OK") and int(line.split()[1]) >= 41, line
