"""FullKernelBatchEngine: the single-kernel flagship bank engine
(port of ``psk_soft_tpu/runtime/engine_full.py:20-578``).

Feed-forward warm-up on the channel-major pipeline (models/blockpsk), carry
hand-off (models/full.full_from_ff), then one kernel B1 launch per
time-major block, with packets for the four REDHAWK ports.  Every block's
window carry is a view of the previous block's last rows, so the JAX
engine's rolling-window fast path and its fallback are one path here.

Lifecycle: ``configure`` (live property change: the kernel carry goes back
to the feed-forward layout, is resynced and re-warms), ``full_state`` /
``restore_full_state`` (mid-stream restart, with utils/checkpoint) and
``guard_nonfinite`` (a channel whose outputs go non-finite restarts alone;
``channel_resyncs`` counts it).

Every config the kernel takes runs here: matched filters (the window
carries the filter's raw look-back, tracked through the warm-up),
``timing_interp``, and with ``ingest_scale`` the int16 wire planes of
``NativePlaneBank("i16")`` (the window carry then stays int16).
``runtime/engine_mixed.MixedKernelBatchEngine`` adds per-channel modes
through the ``_warm_block``, ``_handoff`` and ``_fresh_planes`` hooks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DemodConfig
from ..models import blockpsk, full as full_mod
from ..ops.phase import UNWRAP_TREND_LEN
from ..utils.profiling import TRACER
from .engine_bank import BankAssembler, TMOutputs, _PipelinedPackets
from .engine_stream import EngineMetrics, reconfigure_ff
from .streams import SRI


def _check_cfg(cfg: DemodConfig) -> None:
    """Raise on configs the steady kernel does not serve (at construction
    and before a reconfigure touches any state)."""
    if cfg.sps <= 1:
        raise ValueError("full kernel supports sps > 1")
    if cfg.phase_avg < UNWRAP_TREND_LEN + 1 or cfg.num_avg < 2:
        raise ValueError(f"full kernel requires phase_avg >= "
                         f"{UNWRAP_TREND_LEN + 1} and num_avg >= 2")


def _nonfinite_channels(*planes, axis: int) -> torch.Tensor:
    """(C,) bool: channels with any non-finite value in any plane."""
    ok = torch.ones((), dtype=torch.bool, device=planes[0].device)
    for p in planes:
        ok = ok & torch.isfinite(p)
    return ~ok.all(dim=axis)


def _reset_channels(state, fresh, bad: torch.Tensor):
    """``state`` (a NamedTuple carry, channels leading) with the channels
    flagged in ``bad`` (C,) taken from ``fresh``."""
    return type(state)(*(
        torch.where(bad.reshape((-1,) + (1,) * (o.ndim - 1)), n, o)
        for n, o in zip(fresh, state)))


class FullKernelBatchEngine(_PipelinedPackets):
    """Bank engine for the single-kernel flagship: warms up through the
    channel-major feed-forward pipeline, then hands the carry to kernel B1
    and streams time-major blocks through it, all on ``device`` ("cuda"
    unless the caller asks for the CPU, which runs the plain version).

    ``ingest_scale``: the engine takes int16 wire planes (``push_planes``),
    dequantized as ``i16 * ingest_scale`` -- on the host for the warm-up,
    inside the kernel in the steady state, whose window carry stays int16.
    """

    def __init__(self, cfg: DemodConfig, channels: int,
                 block_symbols: int = 512, pipeline_depth: int = 0,
                 ingest_scale: float | None = None,
                 guard_nonfinite: bool = False,
                 debug_ports: bool = True, data_ports: bool = True,
                 soft_i8: bool = False, soft_i8_scale: float = 100.0, *,
                 device="cuda"):
        if channels % 128:
            raise ValueError("channels must be a multiple of 128")
        if guard_nonfinite and pipeline_depth:
            raise ValueError("guard_nonfinite and pipeline_depth are "
                             "mutually exclusive")
        if guard_nonfinite and soft_i8:
            # The guard reads isfinite off the soft planes; int8 planes
            # quantize non-finite values away.
            raise ValueError("guard_nonfinite and soft_i8 are mutually "
                             "exclusive")
        if ingest_scale is not None and not np.isfinite(ingest_scale):
            raise ValueError(f"ingest_scale must be finite, got "
                             f"{ingest_scale}")
        _check_cfg(cfg)
        self._init_pipeline(pipeline_depth)
        # guard_nonfinite: per-channel drop-and-resync.  Costs one (C,) bool
        # fetch per block to learn which channels went bad.
        self.guard_nonfinite = bool(guard_nonfinite)
        self.channel_resyncs = np.zeros(channels, np.int64)
        self.cfg = cfg
        self.channels = channels
        self.block_symbols = int(block_symbols)
        self.device = torch.device(device)
        self._ingest_scale = (None if ingest_scale is None
                              else float(ingest_scale))
        self._mixed = False         # kernel B1's mixed mode (mixed engine)
        # debug_ports=False = phase/sampleIndex ports unconnected: the
        # kernel never writes those planes and no packets are assembled.
        self.debug_ports = debug_ports
        # soft_i8: int8-quantized soft planes (round(s * scale)); PORT_SOFT
        # packets are dequantized on the host.
        self._soft_scale = float(soft_i8_scale) if soft_i8 else None
        self.assembler = BankAssembler(cfg, skip_debug=not debug_ports,
                                       skip_data=not data_ports)
        self.metrics = EngineMetrics()
        self._blocks = 0            # steady blocks stepped (spans' block)
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
        # Raw input tail for the hand-off under a matched filter: the
        # kernel filters in-kernel, so its window carry holds raw samples,
        # which the warm-up carry does not keep (it stores filtered ones).
        self._raw_tail = torch.zeros((self.channels, 0),
                                     dtype=torch.complex64,
                                     device=self.device)
        self._pending.clear()
        self._held.clear()

    # Hooks (runtime/engine_mixed overrides them).
    def _warm_block(self, state, x: torch.Tensor):
        """One warm-up block of (C, T) complex64 samples."""
        return blockpsk.demod_block_ff(self.cfg, state, x)

    def _handoff(self, raw):
        """Warm-up -> steady-kernel carry conversion."""
        return full_mod.full_from_ff(self.cfg, self._warm_state, raw_win=raw)

    def _fresh_planes(self, planes: torch.Tensor) -> torch.Tensor:
        """Restart value of a guarded channel's state-plane column."""
        return torch.zeros_like(planes)

    @property
    def steady(self) -> bool:
        return self._full_state is not None

    @property
    def full_state(self):
        """The steady kernel's carry as a FullState (None during warm-up):
        the window planes are views of the last block's rows (int16 with
        ``ingest_scale``).  Save it with utils.checkpoint.save_state; resume
        with :meth:`restore_full_state`."""
        return self._full_state

    @property
    def _raw_keep(self) -> int:
        """Raw samples the hand-off needs (0 without a matched filter)."""
        if self.cfg.matched_filter == "none":
            return 0
        return full_mod.window_rows(self.cfg)

    def _track_raw(self, x: torch.Tensor) -> None:
        keep = self._raw_keep
        if keep:
            cat = torch.cat([self._raw_tail, x], dim=1)
            self._raw_tail = cat[:, max(0, cat.shape[1] - keep):]

    def restore_full_state(self, state) -> None:
        """Resume the steady kernel from a checkpointed FullState
        (utils.checkpoint.load_state): an exact mid-stream restart (the
        reference re-converges blind over numAvg*sps samples).  The window
        holds ``window_rows(cfg)`` rows (raw samples under a matched
        filter); an int16-ingest engine quantizes a float32 window, and an
        int16 window needs such an engine.  Staged samples, pipelined
        blocks and the packet clock of the old stream are discarded."""
        rows = full_mod.window_rows(self.cfg)
        if tuple(state.win_re.shape) != (rows, self.channels):
            raise ValueError(
                f"state window is {tuple(state.win_re.shape)}, engine needs "
                f"{(rows, self.channels)} (config/channel mismatch)")
        if state.win_re.dtype == torch.int16 and self._ingest_scale is None:
            raise ValueError("an int16 window needs an engine built with "
                             "ingest_scale")
        self._clear_stream()
        self.assembler.reset()
        st = full_mod.FullState(
            *(t.to(self.device).contiguous() for t in state))
        if self._ingest_scale is not None and st.win_re.is_floating_point():
            st = full_mod.quantize_full_state(st, self._ingest_scale)
        self._full_state = st
        self._warm_state = None
        self._consumed = self.cfg.num_avg + self.cfg.phase_avg

    def _ff_from_full(self):
        """The steady carry back in the feed-forward layout (configure and
        the mixed engine's set_params); under a matched filter the raw
        window also seeds the raw tail for the next hand-off."""
        st = self._full_state
        if self._ingest_scale is not None:
            st = full_mod.dequantize_full_state(st, self._ingest_scale)
        if self.cfg.matched_filter != "none":
            self._raw_tail = torch.complex(st.win_re.T,
                                           st.win_im.T).contiguous()
        self._full_state = None
        return full_mod.ff_from_full(self.cfg, st)

    def configure(self, new_cfg: DemodConfig) -> None:
        """Live property change (C7 resync semantics, reference
        cpp/psk_soft.cpp:638-651).  In-flight blocks are assembled under
        the old config first (held for step_packets).  The kernel carry
        goes back to the feed-forward layout (models/full.ff_from_full),
        is resynced (reconfigure_ff: timing window re-binned or cut, phase
        history kept or cleared) and the engine re-warms on the flexible
        path before handing back to the kernel, so tracking survives
        compatible changes."""
        if new_cfg == self.cfg:
            return
        _check_cfg(new_cfg)
        self._drain_pending()
        ff = (self._ff_from_full() if self._full_state is not None
              else self._warm_state)
        self._warm_state = reconfigure_ff(self.cfg, new_cfg, ff)
        self.cfg = new_cfg
        # Re-run the warm-up gate: a resync may leave partially filled
        # windows that the steady kernel cannot represent.
        self._consumed = 0
        self.assembler.reconfigure(new_cfg)
        self.metrics.reconfigures += 1

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
        if self._ingest_scale is not None:
            raise ValueError("an int16-ingest engine (ingest_scale) takes "
                             "int16 wire planes through push_planes")
        self._staging[channel] = np.concatenate(
            [self._staging[channel], np.asarray(data, np.complex64).ravel()])
        self.metrics.samples_in += data.size

    def push_planes(self, re, im) -> None:
        """Time-major (rows, C) re/im plane append (numpy arrays or tensors
        on any device) -- the native plane bank's output and the kernel's
        input layout, so the steady path uploads with no host transpose.
        float32 planes, or int16 wire planes when the engine was built with
        ``ingest_scale`` (and then only those)."""
        re = torch.as_tensor(re)
        im = torch.as_tensor(im)
        if re.shape != im.shape or re.ndim != 2 or re.shape[1] != self.channels:
            raise ValueError(f"expected (rows, {self.channels}) planes")
        want = torch.float32 if self._ingest_scale is None else torch.int16
        if re.dtype == torch.int16 and self._ingest_scale is None:
            raise ValueError("int16 planes need ingest_scale at construction")
        if re.dtype != want or im.dtype != want:
            raise ValueError(f"planes must be {want}, got {re.dtype}")
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
            if TRACER.on and self.device.type != "cpu":
                up = [p for p in ps if p.device.type == "cpu"]
                TRACER.count("psk.engine.h2d_bytes",
                             sum(p.numel() * p.element_size() for p in up))
                TRACER.count("psk.engine.h2d_copies", len(up))
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
        """Channel-major (C, n) complex64 tensor of a block (warm-up);
        int16 planes dequantized as ``i16 * ingest_scale``."""
        if kind == "planes":
            re, im = blk
            if re.dtype == torch.int16:
                s = self._ingest_scale
                re = re.to(torch.float32) * s
                im = im.to(torch.float32) * s
            return torch.complex(re.T, im.T).contiguous()
        return torch.from_numpy(blk).to(self.device)

    def _tmajor(self, kind, blk, pad: int = 0):
        """Time-major (n + pad, C) planes of a block as they came (float32,
        or int16 wire planes), zero-padded at the end (steady kernel)."""
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
            self.cfg, self._full_state, x_re, x_im, mixed=self._mixed,
            in_scale=self._ingest_scale or 1.0,
            soft_i8_scale=self._soft_scale, debug_ports=self.debug_ports)
        return fo

    def _note_bad(self, bad: torch.Tensor) -> np.ndarray:
        """Count the (C,) bad channels; returns them as a host mask."""
        nbad = bad.cpu().numpy()
        if nbad.any():
            self.channel_resyncs[nbad] += 1
            self.metrics.resets += int(nbad.sum())
        return nbad

    def _guard_full(self, fo) -> None:
        """Per-channel drop-and-resync on the steady carry: a channel with
        a non-finite output this block gets a zero window and zero state
        columns (:meth:`_fresh_planes`), and re-converges within numAvg +
        phaseAvg symbols (the per-channel analogue of the reference's
        queue-flush reset, cpp/psk_soft.cpp:353-357).  The window is a view
        of the caller's block, so it is never zeroed in place: a fresh
        window is built, and only in a block where a channel went bad."""
        phase = fo.phase if fo.phase is not None else fo.soft_re
        bad = _nonfinite_channels(fo.soft_re, fo.soft_im, phase, axis=0)
        if not self._note_bad(bad).any():
            return
        st = self._full_state
        b = bad[None, :]
        self._full_state = full_mod.FullState(
            win_re=torch.where(b, torch.zeros_like(st.win_re), st.win_re),
            win_im=torch.where(b, torch.zeros_like(st.win_im), st.win_im),
            planes=torch.where(b, self._fresh_planes(st.planes), st.planes))

    def _guard_warm(self, out) -> None:
        """Warm-up guard: a channel with a non-finite output restarts its
        feed-forward carry columns from scratch."""
        bad = _nonfinite_channels(out.soft.real, out.soft.imag, out.phase,
                                  axis=-1)
        if not self._note_bad(bad).any():
            return
        self._warm_state = _reset_channels(
            self._warm_state,
            blockpsk.ff_init(self.cfg, self.channels, self.device), bad)

    def _step_core(self):
        """One block: warm-up returns channel-major DemodOutputs; the
        steady kernel returns raw TMOutputs (time-major device planes)."""
        if not self.ready():
            return None
        n = self.block_symbols * self.cfg.sps
        if self._full_state is not None:
            k = self._blocks
            self._blocks += 1
            with TRACER.span("psk.engine.upload", k):
                x_re, x_im = self._tmajor(*self._take_block(n))
            self._consumed += self.block_symbols
            with TRACER.span("psk.engine.launch", k):
                fo = self._steady_step(x_re, x_im)
            if self.guard_nonfinite:
                self._guard_full(fo)
            out = TMOutputs(fo=fo, soft_scale=self._soft_scale, block=k)
        else:
            kind, blk = self._take_block(n)
            self._consumed += self.block_symbols
            x = self._cmajor(kind, blk)
            self._track_raw(x)
            self._warm_state, out = self._warm_block(self._warm_state, x)
            if self.guard_nonfinite:
                self._guard_warm(out)
            if (self._consumed >= self.cfg.num_avg + self.cfg.phase_avg
                    and self._raw_tail.shape[1] >= self._raw_keep):
                st = self._handoff(self._raw_tail if self._raw_keep
                                   else None)
                if self._ingest_scale is not None:
                    st = full_mod.quantize_full_state(st, self._ingest_scale)
                self._full_state = st
                self._warm_state = None
                self._raw_tail = self._raw_tail[:, :0]
        self._count(out)
        return out

    def _count(self, out) -> None:
        if self._pipe_depth == 0:
            nv = self._count_symbols(out)
            self.metrics.symbols_out += nv
            self.metrics.bits_out += nv * self.assembler.cfg.bits_per_symbol

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
        # The assembler's config carries the port layout (a mixed bank's
        # bit planes are as wide as its largest M).
        do = full_mod.to_demod_outputs(self.assembler.cfg, out.fo,
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
            self._warm_state, out = self._warm_block(
                self._warm_state, self._cmajor(kind, blk))
        else:
            pad = self.block_symbols * sps - n
            fo = self._steady_step(*self._tmajor(kind, blk, pad))
            # Output o's window covers carry rows [o, o+numAvg-1]; with a
            # full carry plus n/sps real new rows, windows are fully real
            # for o < n/sps -- the outputs the reference would still emit.
            # A matched filter looks mf_ntaps-1 raw samples ahead, so its
            # last ceil((L-1)/sps) symbols also reach the padding.
            nvalid = n // sps
            if self.cfg.matched_filter != "none":
                nvalid = max(0, nvalid - (-(-(self.cfg.mf_ntaps - 1) // sps)))
            mask = np.zeros(self.block_symbols, bool)
            mask[:nvalid] = True
            out = TMOutputs(fo=fo, valid_rows=mask,
                            soft_scale=self._soft_scale)
        self._count(out)
        return out
