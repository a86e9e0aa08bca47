"""BatchEngine: C aligned streams demodulated as one batched block step
on the engine's device, the channel-parallel path for homogeneous banks
(port of ``psk_soft_tpu/runtime/engine_batch.py:20-166``).  Part of the
runtime/engine facade.
"""

from __future__ import annotations


import numpy as np
import torch

from .. import state as state_mod
from ..config import DemodConfig
from .engine_bank import BankAssembler, _PipelinedPackets
from .engine_full import _nonfinite_channels, _reset_channels
from .engine_stream import EngineMetrics, _PipelineOps, logger, \
    reconfigure_ff
from .streams import SRI


class BatchEngine(_PipelinedPackets):
    """C aligned streams demodulated as one batched block step on
    ``device`` ("cuda" unless the caller asks for the CPU).

    Packets are pushed per channel slot; a block step runs whenever every
    slot holds at least ``block_symbols`` symbols (channelizer-aligned
    streams advance in lockstep).  Flush/reset/reconfigure apply bank-wide,
    like C independent reference components with shared properties.
    ``step()``/``flush()`` return channel-major DemodOutputs;
    ``step_packets()``/``flush_packets()`` the four ports' packets.
    """

    def __init__(self, cfg: DemodConfig, channels: int,
                 block_symbols: int = 512, pipeline: str = "ff",
                 guard_nonfinite: bool = False, pipeline_depth: int = 0, *,
                 device="cuda"):
        self._init_pipeline(pipeline_depth)
        if guard_nonfinite and pipeline_depth:
            # The guard inspects each block's outputs on the host before
            # the next dispatch, which is the sync pipelining removes.
            raise ValueError("guard_nonfinite and pipeline_depth are "
                             "mutually exclusive")
        self.cfg = cfg
        self.channels = channels
        self.block_symbols = int(block_symbols)
        self.guard_nonfinite = guard_nonfinite
        self.device = torch.device(device)
        self._ops = _PipelineOps(pipeline)
        self._state = self._ops.init(cfg, channels, self.device)
        self._staging = [np.zeros(0, np.complex64) for _ in range(channels)]
        self.metrics = EngineMetrics()
        self.channel_resyncs = np.zeros(channels, np.int64)
        self.assembler = BankAssembler(cfg)

    def set_input_sri(self, sri: SRI, t: float = 0.0) -> None:
        """Bank input SRI for packet assembly (step_packets/flush_packets)."""
        self.assembler.set_sri(sri, t)

    def push(self, channel: int, data: np.ndarray) -> None:
        self._staging[channel] = np.concatenate(
            [self._staging[channel], np.asarray(data, np.complex64).ravel()])
        self.metrics.samples_in += data.size

    def ready(self) -> bool:
        need = self.block_symbols * self.cfg.sps
        return all(s.size >= need for s in self._staging)

    def _run_block(self, x: np.ndarray):
        """One block step over a staged (C, T) block; returns outputs."""
        xt = torch.from_numpy(x).to(self.device)
        self._state, out = self._ops.block(self.cfg, self._state, xt)
        return out

    def _count(self, out) -> None:
        if self._pipe_depth == 0:
            nv = int(out.valid.sum())
            self.metrics.symbols_out += nv
            self.metrics.bits_out += nv * self.assembler.cfg.bits_per_symbol

    def _step_core(self):
        """Run one batched block; returns DemodOutputs (C, S) or None."""
        if not self.ready():
            return None
        need = self.block_symbols * self.cfg.sps
        x = np.stack([s[:need] for s in self._staging])
        self._staging = [s[need:] for s in self._staging]
        out = self._run_block(x)
        if self.guard_nonfinite:
            self._guard(out)
        self._count(out)
        return out

    def _guard(self, out) -> None:
        """Per-stream drop-and-resync: a channel whose outputs went
        non-finite (a non-finite input burst, NaN propagation) restarts its
        own carry without touching its neighbours.  One (C,) fetch a
        block."""
        bad = _nonfinite_channels(out.soft.real, out.soft.imag, out.phase,
                                  axis=-1)
        nbad = bad.cpu().numpy()
        if not nbad.any():
            return
        self.channel_resyncs[nbad] += 1
        self.metrics.resets += int(nbad.sum())
        self._state = _reset_channels(
            self._state, self._ops.init(self.cfg, self.channels,
                                        self.device), bad)

    def _flush_core(self):
        """EOS drain: the remaining staged whole symbols (below the block
        size) as one final, shorter step; the < sps tail is dropped like
        the reference's never-completed last window."""
        sps = self.cfg.sps
        n = (min(s.size for s in self._staging) // sps) * sps
        x = np.stack([s[:n] for s in self._staging]) if n else None
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        if x is None:
            return None
        out = self._run_block(x)
        self._count(out)
        return out

    step = _step_core
    flush = _flush_core

    def configure(self, new_cfg: DemodConfig) -> None:
        """Live property change for the whole bank (C7 resync semantics,
        like StreamEngine.configure); in-flight blocks are assembled under
        the old config first."""
        if new_cfg == self.cfg:
            return
        logger.debug("batch reconfigure: %s -> %s", self.cfg, new_cfg)
        self._drain_pending()
        if self._ops.kind == "exact":
            self._state = state_mod.reconfigure(self.cfg, new_cfg,
                                                self._state)
        else:
            self._state = reconfigure_ff(self.cfg, new_cfg, self._state)
        self.cfg = new_cfg
        self.assembler.reconfigure(new_cfg)
        self.metrics.reconfigures += 1

    def reset(self) -> None:
        self._state = self._ops.init(self.cfg, self.channels, self.device)
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        self._pending.clear()
        self._held.clear()
        self.assembler.reset()
        self.metrics.resets += 1
