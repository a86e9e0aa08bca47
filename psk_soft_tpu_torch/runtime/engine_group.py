"""GroupEngine: heterogeneous channel banks bucketed by config into
BatchEngines (channels whose sps/numAvg/phaseAvg differ cannot share one
batched step); port of ``psk_soft_tpu/runtime/engine_group.py:17-138``.
Part of the runtime/engine facade.
"""

from __future__ import annotations

import numpy as np

from ..config import DemodConfig
from ..models.psk import DemodOutputs
from .engine_batch import BatchEngine
from .streams import SRI, Packet, PortStats


def _channel(out: DemodOutputs, slot: int) -> DemodOutputs:
    return DemodOutputs(*(f[slot] for f in out))


class GroupEngine:
    """Heterogeneous channel bank: buckets channels by config (notably sps,
    whose symbol cadence cannot batch) into BatchEngines on ``device``.

    The reference would run one component process per configuration; here
    each distinct config gets one batched step, and channels map to
    (group, slot).
    """

    def __init__(self, channel_cfgs: list[DemodConfig],
                 block_symbols: int = 512, pipeline: str = "ff",
                 pipeline_depth: int = 0, *, device="cuda"):
        groups: dict[DemodConfig, list[int]] = {}
        for ch, cfg in enumerate(channel_cfgs):
            groups.setdefault(cfg, []).append(ch)
        self.groups = []
        self.slot_of = {}
        for cfg, members in groups.items():
            eng = BatchEngine(cfg, channels=len(members),
                              block_symbols=block_symbols, pipeline=pipeline,
                              pipeline_depth=pipeline_depth, device=device)
            gi = len(self.groups)
            self.groups.append((cfg, members, eng))
            for slot, ch in enumerate(members):
                self.slot_of[ch] = (gi, slot)

    def push(self, channel: int, data: np.ndarray) -> None:
        gi, slot = self.slot_of[channel]
        self.groups[gi][2].push(slot, data)

    def set_input_sri(self, sri: SRI, t: float = 0.0) -> None:
        """Bank-wide input SRI for the packet layer (each group's output
        SRIs rescale by its own config's rates)."""
        for _, _, eng in self.groups:
            eng.set_input_sri(sri, t)

    def step_all_packets(self) -> dict[int, dict[str, Packet]]:
        """step_all + packet assembly, per group: {group_index: {port:
        Packet}} (each group is one lockstep bank with its own SRI clock;
        ``self.groups[gi][1]`` lists its channel numbers)."""
        results = {}
        for gi, (_, _, eng) in enumerate(self.groups):
            pkts = eng.step_packets()
            if pkts is not None:
                results[gi] = pkts
        return results

    def flush_all_packets(self) -> dict[int, dict[str, Packet]]:
        """EOS drain with assembly on every group."""
        return {gi: eng.flush_packets()
                for gi, (_, _, eng) in enumerate(self.groups)}

    def step_all(self) -> dict[int, DemodOutputs]:
        """Step every ready group; returns {channel: per-channel outputs}."""
        results = {}
        for _, members, eng in self.groups:
            out = eng.step()
            if out is None:
                continue
            for slot, ch in enumerate(members):
                results[ch] = _channel(out, slot)
        return results

    def configure(self, channel_cfgs: list[DemodConfig]) -> None:
        """Live property change across the bank (C7 passthrough).

        The channel->group partition must be preserved: every channel of a
        group moves to the same new config (each group is one batched
        step).  A partition-changing reconfigure raises rather than
        silently rebucketing, which would discard converged carries; such a
        change needs a new GroupEngine.
        """
        if len(channel_cfgs) != len(self.slot_of):
            raise ValueError(f"expected {len(self.slot_of)} configs, got "
                             f"{len(channel_cfgs)}")
        news = []
        for gi, (_, members, _) in enumerate(self.groups):
            cfgs = {channel_cfgs[ch] for ch in members}
            if len(cfgs) != 1:
                raise ValueError(
                    f"reconfigure splits group {gi} (channels {members}); "
                    f"rebuild the GroupEngine for partition changes")
            news.append(cfgs.pop())
        groups = []
        for new_cfg, (_, members, eng) in zip(news, self.groups):
            eng.configure(new_cfg)
            groups.append((new_cfg, members, eng))
        self.groups = groups

    def flush_all(self) -> dict[int, DemodOutputs]:
        """EOS drain of every group (BatchEngine.flush passthrough)."""
        results = {}
        for _, members, eng in self.groups:
            out = eng.flush()
            if out is None:
                continue
            for slot, ch in enumerate(members):
                results[ch] = _channel(out, slot)
        return results

    def reset(self) -> None:
        """Full state reset of every group (resetState semantics)."""
        for _, _, eng in self.groups:
            eng.reset()

    @property
    def port_stats(self) -> dict[str, PortStats]:
        """Bank-wide per-port statistics: the groups' counters summed (each
        group records its own packet pushes)."""
        merged: dict[str, PortStats] = {}
        for _, _, eng in self.groups:
            for port, s in eng.port_stats.items():
                m = merged.get(port)
                if m is None:
                    merged[port] = m = PortStats()
                    m.last_t, m.last_wall, m._t0 = s.last_t, s.last_wall, s._t0
                m.packets += s.packets
                m.items += s.items
                m.bytes += s.bytes
                m.eos_count += s.eos_count
                m.last_t = max(m.last_t, s.last_t)
                m.last_wall = max(m.last_wall, s.last_wall)
                m._t0 = min(m._t0, s._t0)
        return merged
