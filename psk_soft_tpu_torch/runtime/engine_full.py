"""FullKernelBatchEngine: the single-kernel flagship bank engine
(port of ``psk_soft_tpu/runtime/engine_full.py:20-578``).

Feed-forward warm-up on the channel-major pipeline (models/blockpsk), carry
hand-off (models/full.full_from_ff), then one kernel B1 launch per
time-major block, with packets for the four REDHAWK ports.  Every block's
window carry is a view of the previous block's last rows, so the JAX
engine's rolling-window fast path and its fallback are one path here.

Not ported yet, each raising ValueError that names its ROADMAP step:
``configure``, ``restore_full_state``, ``guard_nonfinite``,
``ingest_scale`` (int16 planes), ``timing_interp`` and matched-filter
configs, the mixed-mode bank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DemodConfig
from ..models import blockpsk, full as full_mod
from ..ops.phase import UNWRAP_TREND_LEN
from .engine_bank import BankAssembler, TMOutputs, _PipelinedPackets
from .engine_stream import EngineMetrics
from .streams import SRI


def _later(what: str, step: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP: {step})")


class FullKernelBatchEngine(_PipelinedPackets):
    """Bank engine for the single-kernel flagship: warms up through the
    channel-major feed-forward pipeline, then hands the carry to kernel B1
    and streams time-major blocks through it, all on ``device`` ("cuda"
    unless the caller asks for the CPU, which runs the plain version)."""

    def __init__(self, cfg: DemodConfig, channels: int,
                 block_symbols: int = 512, pipeline_depth: int = 0,
                 ingest_scale: float | None = None,
                 guard_nonfinite: bool = False,
                 debug_ports: bool = True, data_ports: bool = True,
                 soft_i8: bool = False, soft_i8_scale: float = 100.0, *,
                 device="cuda"):
        if channels % 128:
            raise ValueError("channels must be a multiple of 128")
        if ingest_scale is not None:
            raise _later("int16 ingest (ingest_scale)",
                         "kernel B1 mode 'int16 ingest'")
        if guard_nonfinite:
            raise _later("guard_nonfinite", "engine lifecycle")
        if cfg.matched_filter != "none":
            raise _later("a matched filter on the steady kernel",
                         "kernel B1 mode 'matched filter'")
        if cfg.timing_interp:
            raise _later("timing_interp", "kernel B1 mode 'timing_interp'")
        if cfg.sps <= 1:
            raise ValueError("full kernel supports sps > 1")
        if cfg.phase_avg < UNWRAP_TREND_LEN + 1 or cfg.num_avg < 2:
            raise ValueError(f"full kernel requires phase_avg >= "
                             f"{UNWRAP_TREND_LEN + 1} and num_avg >= 2")
        self._init_pipeline(pipeline_depth)
        self.cfg = cfg
        self.channels = channels
        self.block_symbols = int(block_symbols)
        self.device = torch.device(device)
        # debug_ports=False = phase/sampleIndex ports unconnected: the
        # kernel never writes those planes and no packets are assembled.
        self.debug_ports = debug_ports
        # soft_i8: int8-quantized soft planes (round(s * scale)); PORT_SOFT
        # packets are dequantized on the host.
        self._soft_scale = float(soft_i8_scale) if soft_i8 else None
        self.assembler = BankAssembler(cfg, skip_debug=not debug_ports,
                                       skip_data=not data_ports)
        self.metrics = EngineMetrics()
        self._clear_stream()

    def _clear_stream(self) -> None:
        self._warm_state = blockpsk.ff_init(self.cfg, self.channels,
                                            self.device)
        self._full_state = None
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        self._plane_re: list[torch.Tensor] = []   # staged (rows, C) planes
        self._plane_im: list[torch.Tensor] = []
        self._plane_rows = 0
        self._consumed = 0
        self._pending.clear()

    @property
    def steady(self) -> bool:
        return self._full_state is not None

    def restore_full_state(self, state) -> None:
        raise _later("restore_full_state", "engine lifecycle")

    def configure(self, new_cfg: DemodConfig) -> None:
        raise _later("configure (needs ff_from_full and reconfigure_ff)",
                     "engine lifecycle")

    def reset(self) -> None:
        """Full state reset (the resetState property / queue-flush answer)."""
        self._clear_stream()
        self.assembler.reset()
        self.metrics.resets += 1

    def set_input_sri(self, sri: SRI, t: float = 0.0) -> None:
        self.assembler.set_sri(sri, t)

    def push(self, channel: int, data: np.ndarray) -> None:
        if self._plane_rows:
            raise ValueError("engine is in plane-ingest mode (push_planes); "
                             "per-channel push would interleave streams")
        self._staging[channel] = np.concatenate(
            [self._staging[channel], np.asarray(data, np.complex64).ravel()])
        self.metrics.samples_in += data.size

    def push_planes(self, re, im) -> None:
        """Time-major (rows, C) float32 re/im plane append (numpy arrays or
        tensors on any device) -- the native plane bank's output and the
        kernel's input layout, so the steady path uploads with no host
        transpose."""
        re = torch.as_tensor(re)
        im = torch.as_tensor(im)
        if re.shape != im.shape or re.ndim != 2 or re.shape[1] != self.channels:
            raise ValueError(f"expected (rows, {self.channels}) planes")
        if re.dtype == torch.int16:
            raise _later("int16 planes (ingest_scale)",
                         "kernel B1 mode 'int16 ingest'")
        if re.dtype != torch.float32 or im.dtype != torch.float32:
            raise ValueError(f"planes must be float32, got {re.dtype}")
        if any(s.size for s in self._staging):
            raise ValueError("engine already has per-channel staged data; "
                             "plane and channel pushes cannot mix")
        self._plane_re.append(re)
        self._plane_im.append(im)
        self._plane_rows += re.shape[0]
        self.metrics.samples_in += re.numel()

    def _take_plane_rows(self, rows: int):
        """Pop `rows` rows from the plane staging as contiguous planes on
        the engine's device."""
        take_re, take_im, got = [], [], 0
        while got < rows:
            r, i = self._plane_re[0], self._plane_im[0]
            need = rows - got
            if r.shape[0] <= need:
                take_re.append(r)
                take_im.append(i)
                got += r.shape[0]
                self._plane_re.pop(0)
                self._plane_im.pop(0)
            else:
                take_re.append(r[:need])
                take_im.append(i[:need])
                self._plane_re[0] = r[need:]
                self._plane_im[0] = i[need:]
                got = rows
        self._plane_rows -= rows

        def join(ps):
            # Always a fresh copy on the device: the engine keeps views of
            # it as the next block's window, so it must not alias a buffer
            # the caller may reuse.
            if len(ps) == 1:
                return ps[0].to(self.device, copy=True).contiguous()
            return torch.cat([p.to(self.device) for p in ps])

        return join(take_re), join(take_im)

    def ready(self) -> bool:
        need = self.block_symbols * self.cfg.sps
        if self._plane_rows:
            return self._plane_rows >= need
        return all(s.size >= need for s in self._staging)

    def _take_block(self, n: int):
        """The next n samples of every channel: ("planes", (re, im)) on the
        device, or ("cmajor", (C, n) complex64 numpy)."""
        if self._plane_rows:
            return "planes", self._take_plane_rows(n)
        x = np.stack([s[:n] for s in self._staging])
        self._staging = [s[n:] for s in self._staging]
        return "cmajor", x

    def _cmajor(self, kind, blk) -> torch.Tensor:
        """Channel-major (C, n) complex64 tensor of a block (warm-up)."""
        if kind == "planes":
            return torch.complex(blk[0].T, blk[1].T).contiguous()
        return torch.from_numpy(blk).to(self.device)

    def _tmajor(self, kind, blk, pad: int = 0):
        """Time-major (n + pad, C) float32 planes of a block, zero-padded
        at the end (steady kernel)."""
        if kind == "planes":
            re, im = blk
        else:
            re = torch.from_numpy(np.ascontiguousarray(blk.real.T))
            im = torch.from_numpy(np.ascontiguousarray(blk.imag.T))
        if pad:
            re = torch.nn.functional.pad(re, (0, 0, 0, pad))
            im = torch.nn.functional.pad(im, (0, 0, 0, pad))
        return re.to(self.device).contiguous(), im.to(self.device).contiguous()

    def _steady_step(self, x_re, x_im):
        self._full_state, fo = full_mod.demod_block_full(
            self.cfg, self._full_state, x_re, x_im,
            soft_i8_scale=self._soft_scale, debug_ports=self.debug_ports)
        return fo

    def _step_core(self):
        """One block: warm-up returns channel-major DemodOutputs; the
        steady kernel returns raw TMOutputs (time-major device planes)."""
        if not self.ready():
            return None
        kind, blk = self._take_block(self.block_symbols * self.cfg.sps)
        self._consumed += self.block_symbols
        if self._full_state is None:
            self._warm_state, out = blockpsk.demod_block_ff(
                self.cfg, self._warm_state, self._cmajor(kind, blk))
            if self._consumed >= self.cfg.num_avg + self.cfg.phase_avg:
                self._full_state = full_mod.full_from_ff(self.cfg,
                                                         self._warm_state)
                self._warm_state = None
        else:
            fo = self._steady_step(*self._tmajor(kind, blk))
            out = TMOutputs(fo=fo, soft_scale=self._soft_scale)
        self._count(out)
        return out

    def _count(self, out) -> None:
        if self._pipe_depth == 0:
            nv = self._count_symbols(out)
            self.metrics.symbols_out += nv
            self.metrics.bits_out += nv * self.cfg.bits_per_symbol

    def _count_symbols(self, out) -> int:
        if isinstance(out, TMOutputs):
            sv = (int(out.valid_rows.sum()) if out.valid_rows is not None
                  else out.fo.bits_packed.shape[0])
            return sv * self.channels
        return int(out.valid.sum())

    def _to_cmajor(self, out):
        """TMOutputs -> channel-major DemodOutputs (the step()/flush()
        array surface)."""
        if not isinstance(out, TMOutputs):
            return out
        do = full_mod.to_demod_outputs(self.cfg, out.fo,
                                       soft_i8_scale=out.soft_scale)
        if out.valid_rows is not None:
            rows = torch.as_tensor(out.valid_rows, device=do.valid.device)
            do = do._replace(valid=do.valid & rows[None, :])
        return do

    def step(self):
        """Returns channel-major DemodOutputs or None."""
        return self._to_cmajor(self._step_core())

    def flush(self):
        """EOS drain (channel-major DemodOutputs surface)."""
        return self._to_cmajor(self._flush_core())

    def _flush_core(self):
        """EOS drain.  Before the steady hand-off the feed-forward path
        handles any length; afterwards the remainder is zero-padded to a
        full block through the kernel and outputs whose timing window
        reaches into the padding are masked invalid."""
        sps = self.cfg.sps
        if self._plane_rows:
            n = (self._plane_rows // sps) * sps
        else:
            n = (min(s.size for s in self._staging) // sps) * sps
        if self._full_state is not None and n > self.block_symbols * sps:
            raise ValueError("flush() drains at most one block; call step() "
                             "while ready() first")
        kind, blk = self._take_block(n) if n else (None, None)
        self._plane_re, self._plane_im, self._plane_rows = [], [], 0
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        if n == 0:
            return None
        if self._full_state is None:
            self._warm_state, out = blockpsk.demod_block_ff(
                self.cfg, self._warm_state, self._cmajor(kind, blk))
        else:
            pad = self.block_symbols * sps - n
            fo = self._steady_step(*self._tmajor(kind, blk, pad))
            # Output o's window covers carry rows [o, o+numAvg-1]; with a
            # full carry plus n/sps real new rows, windows are fully real
            # for o < n/sps -- the outputs the reference would still emit.
            mask = np.zeros(self.block_symbols, bool)
            mask[:n // sps] = True
            out = TMOutputs(fo=fo, valid_rows=mask,
                            soft_scale=self._soft_scale)
        self._count(out)
        return out
