"""The engine path: the wire into ``NativePlaneBank``, time-major planes
into ``FullKernelBatchEngine`` (kernel B1) at the mix's pipeline depth, the
reference component's four ports assembled on the host every block by
``step_packets``."""

from __future__ import annotations

import math

import numpy as np
import torch

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
from psk_soft_tpu_torch.runtime.streams import (PORT_BITS, PORT_PHASE,
                                                PORT_SAMPLE_INDEX, PORT_SOFT,
                                                SRI)

from .. import check
from . import ingest
from ..reference import psk

PORTS = (PORT_SOFT, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX)


class Path:
    ports = ("soft", "bits", "phase", "sampleIndex")

    def __init__(self, config: dict, traffic: dict, pool, device, sample):
        self.pool, self.sample = pool, sample
        self.demod = psk.Demod.from_config(config["demod"])
        cfg = DemodConfig(**config["demod"])
        c, s = pool.channels, pool.block_symbols
        self.need = s * cfg.sps
        i16 = traffic["wire"] == "i16"
        self.soft_scale = (float(traffic["soft_i8_scale"])
                           if traffic["soft"] == "i8" else None)
        self.bank = NativePlaneBank(c, capacity_samples=4 * self.need,
                                    dtype="i16" if i16 else "f32")
        self.engine = FullKernelBatchEngine(
            cfg, c, block_symbols=s,
            pipeline_depth=int(traffic["pipeline_depth"]),
            ingest_scale=pool.scale if i16 else None,
            soft_i8=self.soft_scale is not None,
            soft_i8_scale=self.soft_scale or 100.0,
            debug_ports=True, device=device)
        self.engine.set_input_sri(SRI(stream_id="portbench", xdelta=1e-6))
        self.window = False
        self.delivered = 0          # stream blocks whose packets came back
        self.ordinal = 0            # of them, in the window
        self.prev_sidx = None
        # The check's sample: each port of a kept block and the block
        # before's sample index, in buffers touched now, not in the window.
        k, nb = sample.slots, int(math.log2(cfg.constellation_size))
        self.kept_block = np.full(k, -1, np.int64)
        self.kept = tuple(np.ones(shape, dtype) for shape, dtype in (
            ((k, c, s), np.complex64), ((k, c, s * nb), np.int16),
            ((k, c, s), np.float32), ((k, c, s), np.int16),
            ((k, c, s), np.int16)))

    def feed(self, b: int, span):
        re, im = ingest(self.bank, self.pool, b, self.need, span)
        with span("engine.push_planes"):
            self.engine.push_planes(re, im)
        with span("engine.step_packets"):
            pkts = self.engine.step_packets()
        if pkts is None:
            return None, {}
        d = self.delivered
        self.delivered += 1
        shape = (self.pool.channels, self.pool.block_symbols)
        ok = all(p in pkts and pkts[p].data.shape[:2] == shape
                 for p in (PORT_SOFT, PORT_PHASE, PORT_SAMPLE_INDEX)) and \
            PORT_BITS in pkts and \
            pkts[PORT_BITS].data.shape == self.kept[1].shape[1:]
        sidx = pkts[PORT_SAMPLE_INDEX].data if ok else None
        if self.window:
            j = (self.sample.slot(self.ordinal)
                 if ok and self.prev_sidx is not None else None)
            if j is not None:
                self.kept_block[j] = d
                for buf, a in zip(self.kept, [pkts[p].data for p in PORTS]
                                  + [self.prev_sidx]):
                    np.copyto(buf[j], a)
            self.ordinal += 1
        self.prev_sidx = sidx
        return d, ({"samples": self.pool.channels * self.need} if ok
                   else {"failed": 1})

    def close(self) -> None:
        self.bank.close()
        del self.engine, self.bank

    def check(self, dtype=torch.float64, device="cpu"):
        kept = {int(d): tuple(buf[j] for buf in self.kept)
                for j, d in enumerate(self.kept_block) if d >= 0}
        ref = check.run_reference(self.pool, self.demod, None, dtype, device)
        return check.compare_ports(kept, ref, self.pool, self.demod,
                                   self.soft_scale)
