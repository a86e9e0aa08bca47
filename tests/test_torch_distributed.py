"""Port parity, the multi-process layer: two real OS processes form a
gloo process group through parallel/launch.initialize's env-driven path
(PSK_COORDINATOR / PSK_NUM_PROCESSES / PSK_PROCESS_ID), as
tests/test_distributed_launch.py forms JAX's CPU cluster.

- A channel-sharded feed-forward step over the global mesh (two CPU shards
  a process): the all-reduced checksum is equal on both ranks, equal to
  the port's single-process run (float64 sums, relative 1e-9) and to the
  JAX step's (relative 1e-5, its float32 sums).
- DistributedBatchEngine, each process owning 4 of 8 channels: packets
  equal a single-process JAX BatchEngine's row for row (payloads within
  1e-5, timestamps equal), steps and flush (tests/test_distributed_launch
  .py:149-223).
- Time-sharded across the processes (chan 1 x time 2, one shard each, the
  seams over gloo): make_sharded_demod and make_time_sharded_full_demod
  give each process exactly the part a single-process mesh gives that
  shard.

Each worker pair is killed if it hangs (``communicate(timeout=...)``).
"""

import inspect
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def time_case():
    """(cfg, (C, T) samples, their (T, C) planes): the time-sharded case
    the workers and the single-process run share."""
    from psk_soft_tpu_torch.config import DemodConfig

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    rng = np.random.default_rng(11)
    C, NS = 4, 512
    x = np.zeros((C, NS * 8), np.complex64)
    x[:, 3::8] = (np.exp(2j * np.pi * rng.integers(0, 4, (C, NS)) / 4)
                  * np.exp(2j * np.pi * 1e-4 * 8 * np.arange(NS)))
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    planes = (torch.from_numpy(np.ascontiguousarray(x.real.T)),
              torch.from_numpy(np.ascontiguousarray(x.imag.T)))
    return cfg, torch.from_numpy(x), planes


_COMMON = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.parallel import launch
launch.initialize()           # PSK_COORDINATOR / PSK_NUM_PROCESSES / ...
assert launch.num_hosts() == 2
rank = torch.distributed.get_rank()
OUT = os.environ["PSK_OUT"]
"""

_STEP_WORKER = _COMMON + r"""
from psk_soft_tpu_torch.models.blockpsk import (FFState, demod_block_ff,
                                                ff_init)
from psk_soft_tpu_torch.models.psk import DemodOutputs
from psk_soft_tpu_torch.parallel.mesh import (P, NamedSharding, shard,
                                              shard_map)

mesh = launch.global_mesh(devices=["cpu", "cpu"])   # 2 shards a process
assert mesh.shape == {"chan": 4, "time": 1}, mesh
assert mesh.local_coords() == [(2 * rank, 0), (2 * rank + 1, 0)]
cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12)
C, S = 8, 64
rng = np.random.default_rng(0)  # same data in every process
sym = rng.integers(0, 4, size=(C, S))
x_np = np.repeat(np.exp(2j * np.pi * sym / 4), 8,
                 axis=1).astype(np.complex64)
x_np += (0.01 * rng.standard_normal(x_np.shape)).astype(np.complex64)
chan = NamedSharding(mesh, P("chan"))
state = FFState(*(shard(v, chan) for v in ff_init(cfg, C, "cpu")))
specs = FFState(*(P("chan"),) * len(FFState._fields))
step = shard_map(lambda st, xb: demod_block_ff(cfg, st, xb), mesh,
                 in_specs=(specs, P("chan")),
                 out_specs=(specs, DemodOutputs(*(P("chan"),) * 5)),
                 collectives=False)
state, out = step(state, shard(torch.from_numpy(x_np), chan))
assert sorted(out.soft.parts) == mesh.local_coords()
part = sum(out.phase.parts[c].double().sum()
           + out.soft.parts[c].real.double().sum()
           + out.valid.parts[c].double().sum() for c in out.soft.parts)
torch.distributed.all_reduce(part)
print("CHK", repr(float(part)), flush=True)
"""

_RX_WORKER = _COMMON + r"""
from psk_soft_tpu_torch.runtime.distributed import DistributedBatchEngine
from psk_soft_tpu_torch.runtime.streams import SRI

mesh = launch.global_mesh(devices=["cpu"])
cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12)
C, S, BLK = 8, 192, 64
rng = np.random.default_rng(7)              # same data in every process
sym = rng.integers(0, 4, size=(C, S))
x_np = np.repeat(np.exp(2j * np.pi * sym / 4 + 0.35j), 8,
                 axis=1).astype(np.complex64)
x_np += (0.01 * rng.standard_normal(x_np.shape)).astype(np.complex64)
eng = DistributedBatchEngine(cfg, C, mesh=mesh, block_symbols=BLK)
lo, n = eng.local_offset, eng.channels
assert n == 4, (lo, n)
eng.set_input_sri(SRI(stream_id="bank", xdelta=2e-6))
out = {"lo": lo}
step_i = 0
for pos in range(0, S * 8, BLK * 8):
    eng.push_block(x_np[lo:lo + n, pos:pos + BLK * 8])
    pkts = eng.step_packets()
    if pkts:
        for port, p in pkts.items():
            out[f"s{step_i}_{port}"] = p.data
            out[f"s{step_i}_{port}_t"] = np.float64(p.t)
        step_i += 1
# A drain that is not the same length everywhere is refused, everywhere.
eng.push_block(x_np[lo:lo + n, : 8 * (3 + rank)])
try:
    eng.flush_packets()
    raise AssertionError("unequal drain lengths were taken")
except ValueError as e:
    assert "drain lengths differ" in str(e)
eng.reset()
eng.set_input_sri(SRI(stream_id="bank", xdelta=2e-6))
for pos in range(0, S * 8, BLK * 8):
    eng.push_block(x_np[lo:lo + n, pos:pos + BLK * 8])
    eng.step_packets()
pkts = eng.flush_packets()
for port, p in (pkts or {}).items():
    out[f"f_{port}"] = p.data
    out[f"f_{port}_t"] = np.float64(p.t)
out["steps"] = np.int64(step_i)
np.savez(os.path.join(OUT, f"rx_{rank}.npz"), **out)
print("DONE", flush=True)
"""

_TIME_WORKER = _COMMON + inspect.getsource(time_case) + r"""
from psk_soft_tpu_torch.parallel.mesh import NamedSharding, P, shard
from psk_soft_tpu_torch.parallel.sharded import make_sharded_demod
from psk_soft_tpu_torch.parallel.sharded_full import \
    make_time_sharded_full_demod

mesh = launch.global_mesh(chan=1, time=2, devices=["cpu"])
assert mesh.local_coords() == [(0, rank)]
cfg, x, planes = time_case()
out = make_sharded_demod(cfg, mesh, x.shape[1] // cfg.sps)(
    shard(x, NamedSharding(mesh, P("chan", "time"))))
sh = NamedSharding(mesh, P("time", "chan"))
full = make_time_sharded_full_demod(cfg, mesh, planes[0].shape[0] // 8)(
    shard(planes[0], sh), shard(planes[1], sh))
save = {f"sharded_{k}": v.parts[(0, rank)].numpy()
        for k, v in out._asdict().items()}
save.update({f"full_{i}": v.parts[(0, rank)].numpy()
             for i, v in enumerate(full)})
np.savez(os.path.join(OUT, f"time_{rank}.npz"), **save)
print("DONE", flush=True)
"""


def _launch_pair(tmp_path, worker: str, timeout: float = 240) -> list:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(worker)
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("PSK_COORDINATOR", "PSK_NUM_PROCESSES",
                             "PSK_PROCESS_ID")}
    procs = []
    for pid in range(2):
        env = dict(env_base, PYTHONPATH=str(REPO), PSK_OUT=str(tmp_path),
                   PSK_COORDINATOR=f"localhost:{port}",
                   PSK_NUM_PROCESSES="2", PSK_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("distributed worker hung")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


def test_two_process_launch_checksum(tmp_path):
    outs = _launch_pair(tmp_path, _STEP_WORKER)
    chks = [float(o.split("CHK")[1].strip()) for o in outs]
    assert chks[0] == chks[1] and np.isfinite(chks[0])

    # The same step in one process, and JAX's.
    import jax
    import jax.numpy as jnp

    from psk_soft_tpu import DemodConfig as JaxDemodConfig
    from psk_soft_tpu.models.blockpsk import demod_block_ff as jax_step
    from psk_soft_tpu.models.blockpsk import ff_init as jax_init
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models.blockpsk import demod_block_ff, ff_init

    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12)
    C, S = 8, 64
    rng = np.random.default_rng(0)
    sym = rng.integers(0, 4, size=(C, S))
    x_np = np.repeat(np.exp(2j * np.pi * sym / 4), 8,
                     axis=1).astype(np.complex64)
    x_np += (0.01 * rng.standard_normal(x_np.shape)).astype(np.complex64)
    _, out = demod_block_ff(cfg, ff_init(cfg, C, "cpu"),
                            torch.from_numpy(x_np))
    single = float(out.phase.double().sum() + out.soft.real.double().sum()
                   + out.valid.double().sum())
    assert abs(chks[0] - single) <= 1e-9 * abs(single)
    jcfg = JaxDemodConfig(sps=8, num_avg=20, constellation_size=4,
                          phase_avg=12)
    _, jout = jax.vmap(lambda s, b: jax_step(jcfg, s, b))(
        jax_init(jcfg, (C,)), jnp.asarray(x_np))
    jchk = float(jnp.sum(jout.phase) + jnp.sum(jout.soft.real)
                 + jnp.sum(jout.valid))
    assert abs(chks[0] - jchk) <= 1e-5 * abs(jchk)


def test_two_process_distributed_engine_packet_parity(tmp_path):
    """DistributedBatchEngine's packets (2 processes, each owning 4 of 8
    channels) equal a single-process JAX BatchEngine's row for row --
    payloads, ports and timestamps."""
    outs = _launch_pair(tmp_path, _RX_WORKER)
    assert all("DONE" in o for o in outs)

    from psk_soft_tpu import DemodConfig as JaxDemodConfig
    from psk_soft_tpu.runtime.engine import BatchEngine
    from psk_soft_tpu.runtime.streams import SRI

    cfg = JaxDemodConfig(sps=8, num_avg=20, constellation_size=4,
                         phase_avg=12)
    C, S, BLK = 8, 192, 64
    rng = np.random.default_rng(7)
    sym = rng.integers(0, 4, size=(C, S))
    x_np = np.repeat(np.exp(2j * np.pi * sym / 4 + 0.35j), 8,
                     axis=1).astype(np.complex64)
    x_np += (0.01 * rng.standard_normal(x_np.shape)).astype(np.complex64)
    eng = BatchEngine(cfg, C, block_symbols=BLK)
    eng.set_input_sri(SRI(stream_id="bank", xdelta=2e-6))
    ref_steps = []
    for pos in range(0, S * 8, BLK * 8):
        eng.push_block(x_np[:, pos:pos + BLK * 8])
        pkts = eng.step_packets()
        if pkts:
            ref_steps.append(pkts)
    ref_flush = eng.flush_packets()

    for pid in range(2):
        z = np.load(tmp_path / f"rx_{pid}.npz")
        lo = int(z["lo"])
        assert lo == pid * 4
        assert int(z["steps"]) == len(ref_steps)
        for i, pkts in enumerate(ref_steps):
            for port, p in pkts.items():
                np.testing.assert_allclose(z[f"s{i}_{port}"],
                                           p.data[lo:lo + 4], rtol=0,
                                           atol=1e-5)
                assert float(z[f"s{i}_{port}_t"]) == p.t
        for port, p in (ref_flush or {}).items():
            if p.data.size:
                np.testing.assert_allclose(z[f"f_{port}"],
                                           p.data[lo:lo + 4], rtol=0,
                                           atol=1e-5)
            assert float(z[f"f_{port}_t"]) == p.t


def test_two_process_time_sharded_equals_one_process(tmp_path):
    outs = _launch_pair(tmp_path, _TIME_WORKER)
    assert all("DONE" in o for o in outs)

    from psk_soft_tpu_torch.parallel.mesh import (NamedSharding, P,
                                                  make_mesh, shard)
    from psk_soft_tpu_torch.parallel.sharded import make_sharded_demod
    from psk_soft_tpu_torch.parallel.sharded_full import \
        make_time_sharded_full_demod

    cfg, x, planes = time_case()
    mesh = make_mesh(chan=1, time=2, devices=["cpu"] * 2)
    out = make_sharded_demod(cfg, mesh, x.shape[1] // cfg.sps)(
        shard(x, NamedSharding(mesh, P("chan", "time"))))
    sh = NamedSharding(mesh, P("time", "chan"))
    full = make_time_sharded_full_demod(cfg, mesh, planes[0].shape[0] // 8)(
        shard(planes[0], sh), shard(planes[1], sh))
    for rank in range(2):
        z = np.load(tmp_path / f"time_{rank}.npz")
        for k, v in out._asdict().items():
            np.testing.assert_array_equal(z[f"sharded_{k}"],
                                          v.parts[(0, rank)].numpy(),
                                          err_msg=k)
        for i, v in enumerate(full):
            np.testing.assert_array_equal(z[f"full_{i}"],
                                          v.parts[(0, rank)].numpy(),
                                          err_msg=str(i))
