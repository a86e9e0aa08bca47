"""Multi-process runtime: the distributed receiver (port of
``psk_soft_tpu/runtime/distributed.py:1-177``).

BASELINE config 5 (4096 channels across processes) at the RUNTIME layer:
each process ingests ITS OWN channels (its local slice of the global
bank), demodulates them, and assembles packets for its local channels
only.  The reference's analog is one component per host deployed under a
domain manager (cpp/main.cpp:24-29); here the "domain" is the
``torch.distributed`` process group (parallel/launch.py) and the component
is this engine.

Launch recipe (every process runs the same program):

    from psk_soft_tpu_torch.parallel import launch
    from psk_soft_tpu_torch.runtime.distributed import DistributedBatchEngine

    launch.initialize()          # PSK_COORDINATOR / PSK_NUM_PROCESSES /
                                 # PSK_PROCESS_ID
    eng = DistributedBatchEngine(cfg, channels_global=4096)
    eng.set_input_sri(sri)
    for block in my_ingest():            # (eng.channels, S*sps) local rows
        eng.push_block(block)
        pkts = eng.step_packets()        # packets for the LOCAL channels

Design notes:

- The channel axis is communication-free (SURVEY section 2.5): the step
  has no collective.  Each process's shards of the chan-sharded mesh sit
  on its one device, and their per-shard block steps are one batched step
  over the process's rows there (the per-channel math is the same).
- A process never holds another process's samples or carry: its state is
  its own rows.
- Packet assembly (SRI propagation, symbol-accurate timestamps, EOS) is
  the SAME BankAssembler the single-process engines use, over the local
  rows -- a 2-process run is packet-for-packet identical to a
  single-process run of the same bank (tests/test_torch_distributed.py).
- The drain lengths must agree across processes, as the JAX package's one
  SPMD program needs: ``flush`` checks them (one small ``all_gather``)
  and raises when they differ, so every process flushes together.
"""

from __future__ import annotations

import torch

from ..config import DemodConfig
from ..parallel.mesh import Mesh
from .engine_batch import BatchEngine


class DistributedBatchEngine(BatchEngine):
    """Channel-sharded multi-process bank engine.

    Args:
      cfg: demod configuration (shared by the whole bank).
      channels_global: total channels across all processes; must divide
        evenly over the mesh's shards.
      mesh: a mesh over the GLOBAL device list whose shards split the
        channels, chan-major (default: ``launch.global_mesh()`` -- all
        devices on chan).  This process's shards must be contiguous in that
        order and on one device, the engine's.
      block_symbols / pipeline / pipeline_depth: as BatchEngine.

    The engine's public surface (``push`` / ``push_block`` /
    ``step_packets`` / ``flush_packets`` / metrics) is the LOCAL view:
    ``self.channels`` is the local channel count and ``local_offset`` is
    the first global channel this process owns.  ``reset`` and
    ``configure`` are BatchEngine's over the local rows; every process
    calls them together, with the same config (the single-program
    discipline of the JAX engine).
    """

    def __init__(self, cfg: DemodConfig, channels_global: int,
                 mesh: Mesh | None = None, block_symbols: int = 512,
                 pipeline: str = "ff", pipeline_depth: int = 0,
                 guard_nonfinite: bool = False):
        if guard_nonfinite:
            # The JAX engine's guard rebuilds a carry sized to local rows
            # inside a global sharded state; refuse it here as there,
            # rather than build a guard that behaves differently per host.
            raise ValueError("guard_nonfinite is not supported on the "
                             "distributed engine (per-channel resync is "
                             "host-local; run it on the per-host view)")
        if mesh is None:
            from ..parallel.launch import global_mesh
            mesh = global_mesh()
        n_dev = mesh.size
        if channels_global % n_dev:
            raise ValueError(f"{channels_global} channels not divisible "
                             f"by {n_dev} devices")
        per = channels_global // n_dev
        # Shard (c, t) owns channel rows [k*per, (k+1)*per) for its
        # chan-major position k (JAX's P(("chan", "time")) on the rows).
        coords = mesh.coords()
        local = mesh.local_coords()
        if not local:
            raise ValueError(f"this process owns no shard of {mesh!r}")
        pos = [coords.index(co) for co in local]
        if pos != list(range(pos[0], pos[0] + len(pos))):
            raise ValueError("process-local channel rows are not "
                             "contiguous on this mesh; reorder devices")
        devs = {mesh.devices[co] for co in local}
        if len(devs) != 1:
            raise ValueError(f"this process's shards sit on "
                             f"{sorted(map(str, devs))}; the engine steps "
                             f"them on one device")
        self.mesh = mesh
        self.channels_global = int(channels_global)
        self.local_offset = pos[0] * per
        super().__init__(cfg, per * len(pos), block_symbols=block_symbols,
                         pipeline=pipeline, pipeline_depth=pipeline_depth,
                         device=devs.pop())

    def _spans_processes(self) -> bool:
        dist = torch.distributed
        return (not self.mesh.is_local and dist.is_initialized()
                and dist.get_world_size() > 1)

    def _flush_core(self):
        """EOS drain, after checking that every process drains the same
        number of samples (the equal-drain-lengths rule)."""
        if self._spans_processes():
            sps = self.cfg.sps
            n = (min(s.size for s in self._staging) // sps) * sps
            lengths: list = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(lengths, n)
            if len(set(lengths)) != 1:
                raise ValueError(f"drain lengths differ across processes "
                                 f"({lengths} samples): feed equal-length "
                                 f"streams or flush at block edges")
        return super()._flush_core()

    flush = _flush_core
