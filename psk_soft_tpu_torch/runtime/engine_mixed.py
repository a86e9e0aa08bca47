"""MixedKernelBatchEngine: one kernel B1 launch a block over a
heterogeneous (M, differential) bank, BASELINE config 4 (port of
``psk_soft_tpu/runtime/engine_mixed.py:19-157``).

The per-channel modes live in the carry's mode rows (kernel B1's ``mixed``
mode); the warm-up runs models/mixed.  Everything else is
FullKernelBatchEngine's: plane ingest (int16 wire planes with
``ingest_scale``), packets, flush, reset, configure, checkpoints and the
guard.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import DemodConfig
from ..models import full as full_mod
from ..models.mixed import MixedParams, demod_block_mixed
from ..ops.phase import UNWRAP_TREND_LEN
from .engine_bank import BankAssembler
from .engine_full import FullKernelBatchEngine


class MixedKernelBatchEngine(FullKernelBatchEngine):
    """One kernel demodulates a bank whose channels differ in M and in
    differential decoding (GroupEngine-style bucketing is still needed when
    sps, num_avg or phase_avg differ).  The shared config's
    constellation_size and differential are ignored; packets use one bit
    port layout as wide as the bank's largest M (3 planes for {2, 4, 8}),
    and consumers mask with ``params.bits_per_symbol``.

    ``set_params`` is the per-channel analogue of the reference's
    constellation-change listener (cpp/psk_soft.cpp:643-646, applied per
    channel): channels whose M changed get their phase history cleared;
    a differential-only change keeps tracking.
    """

    def __init__(self, params, cfg: DemodConfig, channels: int,
                 block_symbols: int = 512, pipeline_depth: int = 0,
                 ingest_scale: float | None = None,
                 guard_nonfinite: bool = False, debug_ports: bool = True,
                 soft_i8: bool = False, soft_i8_scale: float = 100.0, *,
                 device="cuda"):
        params = self._check_params(params, channels)
        super().__init__(cfg, channels, block_symbols=block_symbols,
                         pipeline_depth=pipeline_depth,
                         ingest_scale=ingest_scale,
                         guard_nonfinite=guard_nonfinite,
                         debug_ports=debug_ports, soft_i8=soft_i8,
                         soft_i8_scale=soft_i8_scale, device=device)
        self.params = params.to(self.device)
        self._mixed = True
        self.assembler = BankAssembler(self._port_cfg(cfg),
                                       skip_debug=not debug_ports)

    @staticmethod
    def _check_params(params, channels: int) -> MixedParams:
        p = MixedParams.make(torch.as_tensor(params.m).cpu(),
                             torch.as_tensor(params.diff).cpu(), "cpu")
        if tuple(p.m.shape) != (channels,):
            raise ValueError(f"params must carry {channels} channel modes")
        if not bool(torch.isin(p.m, torch.tensor([2, 4, 8, 16, 32])).all()):
            raise ValueError("every channel's M must be 2, 4, 8, 16 or 32")
        return p

    def _port_cfg(self, cfg: DemodConfig) -> DemodConfig:
        return dataclasses.replace(
            cfg, constellation_size=1 << self.params.max_bits,
            differential=False)

    def _warm_block(self, state, x: torch.Tensor):
        return demod_block_mixed(self.cfg, self.params, state, x,
                                 self.params.max_bits)

    def _handoff(self, raw):
        return full_mod.full_from_ff(self.cfg, self._warm_state, raw_win=raw,
                                     mixed_params=self.params)

    def _fresh_planes(self, planes: torch.Tensor) -> torch.Tensor:
        """A guarded channel restarts with zero tracking but keeps its mode
        rows (losing them would turn a poisoned 8-PSK channel into BPSK)."""
        misc = (self.cfg.phase_avg - 1) + 2 * (UNWRAP_TREND_LEN - 1)
        z = torch.zeros_like(planes)
        z[misc + 6] = self.params.m.to(planes.dtype)
        z[misc + 7] = self.params.diff.to(planes.dtype)
        return z

    def configure(self, new_cfg: DemodConfig) -> None:
        """Shared-property change; the port layout stays as wide as the
        bank's largest M."""
        super().configure(new_cfg)
        self.assembler.reconfigure(self._port_cfg(new_cfg))

    def set_params(self, new_params) -> None:
        """Live per-channel mode change (C7, per channel): the steady carry
        goes back to the feed-forward layout, channels whose M changed have
        their phase history cleared, and the engine re-warms before the
        kernel takes over again with the new mode rows."""
        new = self._check_params(new_params, self.channels).to(self.device)
        self._drain_pending()
        ff = (self._ff_from_full() if self._full_state is not None
              else self._warm_state)
        changed = self.params.m != new.m
        if bool(changed.any()):
            c = changed.unsqueeze(-1)
            ff = ff._replace(
                phase_hist=torch.where(c, torch.zeros_like(ff.phase_hist),
                                       ff.phase_hist),
                phase_count=torch.where(changed,
                                        torch.zeros_like(ff.phase_count),
                                        ff.phase_count),
                last_phase=torch.where(changed,
                                       torch.zeros_like(ff.last_phase),
                                       ff.last_phase))
        self.params = new
        self._warm_state = ff
        self._consumed = 0                     # re-run the warm-up gate
        if self.params.max_bits != self.assembler.cfg.bits_per_symbol:
            self.assembler.reconfigure(self._port_cfg(self.cfg))
        self.metrics.reconfigures += 1

