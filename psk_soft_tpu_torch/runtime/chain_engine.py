"""The receive chain as an engine (port of
``psk_soft_tpu/runtime/chain_engine.py:53-472``).

``ChainEngine`` runs capture -> kernel B1 -> seam frame sync -> Viterbi
(kernel B2) -> CRC per block (``models/chain.make_chain_fn``) behind an
ingest/drain surface; the only device-to-host traffic per block is the
decoded-frame table.

Semantics, as in the JAX engine:

- **Warm-up**: the first block converges the tracker through the
  feed-forward pipeline (``models/blockpsk``), then hands the carry to
  kernel B1 (``models/full.full_from_ff``).  The carried seam tail starts
  from the warm block's own soft output, so frames straddling the warm-up
  boundary are caught; frames wholly inside the early warm region are lost
  (``warmup_symbols`` counts the warm block).
- **Seam contract**: thereafter every stream position is committed in
  exactly one block.  ``flush()`` drains whole staged blocks (fewer than
  ``block_symbols * sps`` trailing samples are dropped, the reference
  behaviour) and finalizes the carried tail: frames whose payload is fully
  present commit.
- **Observability**: ``frames_synced``, ``crc_failures`` and
  ``overflow_peaks`` (count > k, never silent).

- **Carrier acquisition** (``acquire_cfo=True``): the warm block gives a
  per-channel coarse offset (M-th-power spectrum, ``eval/cfo.acquire_cfo``)
  and is derotated on the host; the steady blocks run the front chain
  (``models/chain.make_front_chain_fn``) whose NCO continues the warm
  block's phase.  ``set_cfo`` changes the frequencies mid-stream.

Frames come back as ``ops/framesync.Frame`` objects with ``start`` in
input-symbol coordinates (a frame planted at input symbol p syncs at
start == p), ``info_bits`` decoded and ``crc_ok`` set when a CRC is
configured.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DemodConfig
from ..eval.cfo import acquire_cfo as acquire_cfo_host
from ..models import blockpsk
from ..models.chain import (ChainState, FrontChainState, FrontState,
                            SeamTailState, _need_after, chain_msg_bits,
                            chain_tail, make_chain_fn, make_front_chain_fn,
                            seam_lead, seam_tail_init)
from ..models.full import full_from_ff
from ..ops.crc import CrcSpec
from ..ops.fec import ConvCode
from ..ops.framesync import Frame, FrameFormat
from ..ops.mixer import derotate_host
from ..ops.phase import wrap_to_pi


class ChainEngine:
    """Chain engine over a homogeneous channel bank, on ``device``.

    Args:
      cfg: demod configuration (matched_filter "none" only).
      channels: bank width.
      fmt: frame format (UW indices, payload, M == cfg.constellation_size,
        threshold).
      code / crc: FEC and optional CRC.
      k_frames: sync capacity per block per channel (default:
        block_symbols // separation + 1).
      block_symbols: symbols per device step.
      pipeline_depth: 0 = synchronous; 1 = commit block k-1 after block
        k's device work has been queued (frames lag one step).
      acquire_cfo: estimate a per-channel carrier offset from the warm
        block and remove it with the front chain's NCO: offsets beyond the
        tracker's pull-in (~1/(2*pi*M*sps) per symbol) up to the
        acquisition's unambiguous |cfo| < 1/(2M) cycles/sample (beyond it
        the estimate aliases and CRC failures show it).  Fixed after the
        warm-up unless :meth:`set_cfo` changes it.
      labeling: payload bit labeling, "gray" or "scd".
      device: where the chain runs ("cuda" unless the caller asks for the
        CPU, which runs every kernel's plain version).
    """

    def __init__(self, cfg: DemodConfig, channels: int, fmt: FrameFormat,
                 code: ConvCode, crc: CrcSpec | None = None, *,
                 k_frames: int | None = None, block_symbols: int = 512,
                 pipeline_depth: int = 0, acquire_cfo: bool = False,
                 labeling: str = "gray", device="cuda"):
        if pipeline_depth not in (0, 1):
            raise ValueError("pipeline_depth must be 0 (synchronous) or "
                             "1 (commit block k-1 while block k's device "
                             "work is in flight)")
        if fmt.m != cfg.constellation_size:
            raise ValueError(f"fmt.m={fmt.m} != constellation_size="
                             f"{cfg.constellation_size}")
        if cfg.matched_filter != "none":
            raise ValueError("ChainEngine supports matched_filter='none' "
                             "configs; use the per-stage stack (engine + "
                             "FrameSyncer + FecFrameDecoder) otherwise")
        self.cfg = cfg
        self.channels = channels
        self.fmt = fmt
        self.code = code
        self.crc = crc
        self.device = torch.device(device)
        self.block_symbols = int(block_symbols)
        if self.block_symbols < _need_after(fmt):
            raise ValueError(f"block_symbols {block_symbols} shorter than "
                             f"the sync window {_need_after(fmt)}")
        self.k = (k_frames if k_frames is not None
                  else self.block_symbols // fmt.separation + 1)
        self.n_msg = chain_msg_bits(fmt, code, crc)
        self._labeling = labeling
        self.acquire_cfo = bool(acquire_cfo)
        make = make_front_chain_fn if self.acquire_cfo else make_chain_fn
        self._step = make(cfg, fmt, code, self.k, crc=crc, labeling=labeling)
        self._pipe_depth = int(pipeline_depth)
        self.frames_synced = 0
        self.crc_failures = 0
        self.overflow_peaks = 0
        self.warmup_symbols = 0
        self.reset()

    # -- ingest ------------------------------------------------------------

    def push(self, channel: int, data) -> None:
        self._check_open()
        if self._plane_rows:
            raise ValueError("engine already has plane-staged data; "
                             "plane and channel pushes cannot mix")
        self._staging[channel] = np.concatenate(
            [self._staging[channel],
             np.asarray(data, np.complex64).ravel()])

    def push_block(self, block) -> None:
        block = np.asarray(block, np.complex64)
        for c in range(self.channels):
            self.push(c, block[c])

    def push_planes(self, re, im) -> None:
        """Time-major (rows, C) float32 I/Q planes (host arrays; the
        NativePlaneBank output layout).  Integer wire planes must be
        dequantized first (no in-kernel ingest_scale)."""
        self._check_open()
        re = np.asarray(re)
        im = np.asarray(im)
        if np.issubdtype(re.dtype, np.integer) \
                or np.issubdtype(im.dtype, np.integer):
            raise ValueError("integer wire planes must be dequantized "
                             "before push_planes (multiply by the wire "
                             "scale); ChainEngine has no in-kernel "
                             "ingest_scale")
        re = np.asarray(re, np.float32)
        im = np.asarray(im, np.float32)
        if re.shape != im.shape or re.ndim != 2 \
                or re.shape[1] != self.channels:
            raise ValueError(f"planes must be (rows, {self.channels})")
        if any(st.size for st in self._staging):
            raise ValueError("engine already has per-channel staged "
                             "data; plane and channel pushes cannot mix")
        self._plane_re.append(re)
        self._plane_im.append(im)
        self._plane_rows += re.shape[0]

    def _pop_planes(self, need: int):
        """Pop ``need`` rows from the plane staging."""
        take_re, take_im, got = [], [], 0
        while got < need:
            r, i = self._plane_re[0], self._plane_im[0]
            want = need - got
            if r.shape[0] <= want:
                take_re.append(r)
                take_im.append(i)
                got += r.shape[0]
                self._plane_re.pop(0)
                self._plane_im.pop(0)
            else:
                take_re.append(r[:want])
                take_im.append(i[:want])
                self._plane_re[0] = r[want:]
                self._plane_im[0] = i[want:]
                got = need
        self._plane_rows -= need
        return np.concatenate(take_re), np.concatenate(take_im)

    def _check_open(self) -> None:
        if self._finalized:
            raise ValueError("stream finalized by flush(); reset() or "
                             "restore_chain_state() to start a new one")

    def ready(self) -> bool:
        need = self.block_symbols * self.cfg.sps
        if self._plane_rows >= need:
            return True
        return all(s.size >= need for s in self._staging)

    # -- core --------------------------------------------------------------

    def _upload(self, plane: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(plane)).to(self.device)

    def _warm(self, x: np.ndarray) -> None:
        """Converge through the feed-forward pipeline; seed the seam tail
        from the warm block's own soft output.  With acquire_cfo the warm
        block first gives the coarse offsets and is derotated on the host."""
        freq = None
        if self.acquire_cfo:
            freq = np.asarray(acquire_cfo_host(x, self.cfg.constellation_size),
                              np.float32)
            x = derotate_host(x, freq)
        st_ff, out = blockpsk.demod_block_ff(
            self.cfg, blockpsk.ff_init(self.cfg, self.channels, self.device),
            torch.from_numpy(x).to(self.device))
        full = full_from_ff(self.cfg, st_ff)
        lead = seam_lead(self.fmt)
        idx = np.flatnonzero(out.valid[0].cpu().numpy())   # lockstep bank
        tail = seam_tail_init(self.fmt, self.channels, self.device)
        if idx.size:
            lo = max(int(idx[0]), int(idx[-1]) + 1 - lead)
            hi = int(idx[-1]) + 1
            soft = out.soft[:, lo:hi]                       # (C, n) complex
            n = soft.shape[1]
            t_re, t_im = tail.tail_re.clone(), tail.tail_im.clone()
            t_re[lead - n:] = soft.real.T
            t_im[lead - n:] = soft.imag.T
            tail = SeamTailState(t_re, t_im)
        if self.acquire_cfo:
            # NCO phase continuity: derotate_host ran the warm block from
            # phase 0, so the NCO starts where it left off.
            phase = wrap_to_pi(torch.from_numpy(
                2 * np.pi * freq * x.shape[1]))
            front = FrontState(freq=torch.from_numpy(freq).to(self.device),
                               phase=phase.to(self.device), agc=None)
            self._state = FrontChainState(front, full, tail)
        else:
            self._state = ChainState(full, tail)
        self.warmup_symbols = self._base = x.shape[1] // self.cfg.sps

    def _commit(self, out, block_index: int) -> list[Frame]:
        """ChainOutputs -> Frame objects (input-symbol start coordinates);
        ``block_index`` is the 1-based chain-block number of ``out``."""
        found = out.found.cpu().numpy()
        pos = out.pos.cpu().numpy()
        ok = out.ok.cpu().numpy()
        msg = out.msg.cpu().numpy()
        count = out.count.cpu().numpy()
        ang = out.ang.cpu().numpy()
        self.overflow_peaks += int(np.maximum(count - self.k, 0).sum())
        a1 = self.cfg.num_avg - 1
        # Row r of chain block b is input symbol base - a1 + (b-1)*S + r.
        base = self._base - a1 + (block_index - 1) * self.block_symbols
        new = []
        for c, j in zip(*np.nonzero(found)):
            crc_ok = bool(ok[c, j]) if self.crc is not None else None
            if self.crc is not None and not ok[c, j]:
                self.crc_failures += 1
            new.append(Frame(
                channel=int(c), start=base + int(pos[c, j]), rotation=0,
                corr=0.0, residual_phase=float(ang[c, j]),
                soft=None, bits=None, info_bits=msg[c, j].copy(),
                crc_ok=crc_ok))
        self.frames_synced += len(new)
        self.frames.extend(new)
        return new

    def step(self) -> list[Frame] | None:
        """Consume one staged block; returns the frames committed by this
        call (empty for the warm-up block), or None if not enough data.
        With ``pipeline_depth=1`` the returned frames are the previous
        block's; flush() drains the last one."""
        if not self.ready():
            return None
        need = self.block_symbols * self.cfg.sps
        if self._plane_rows >= need:
            re_t, im_t = self._pop_planes(need)
            if self._state is None:
                x = np.empty((self.channels, need), np.complex64)
                x.real = re_t.T
                x.imag = im_t.T
                self._warm(x)
                return []
        else:
            x = np.stack([s[:need] for s in self._staging])
            self._staging = [s[need:] for s in self._staging]
            if self._state is None:
                self._warm(x)
                return []
            re_t, im_t = x.real.T, x.imag.T
        self._state, out = self._step(self._state, self._upload(re_t),
                                      self._upload(im_t))
        self._blocks += 1
        if self._pipe_depth == 0:
            return self._commit(out, self._blocks)
        self._pending.append((self._blocks, out))
        if len(self._pending) > self._pipe_depth:
            bi, prev = self._pending.pop(0)
            return self._commit(prev, bi)
        return []

    def flush(self) -> list[Frame]:
        """End of stream: drain whole staged blocks, then finalize the
        carried tail (frames whose payload is fully present commit)."""
        if self._finalized:                   # idempotent at EOS
            return []
        out_frames = []
        while self.ready():
            out_frames += self.step() or []
        for bi, out in self._pending:         # drain in-flight blocks
            out_frames += self._commit(out, bi)
        self._pending = []
        self._finalized = True
        if self._state is None:
            return out_frames
        lead = seam_lead(self.fmt)
        # Tail-relative window: positions after the last block's commit_hi
        # (lead - need_after in tail coordinates) through the last start
        # whose payload is fully inside the tail planes.
        t_lo = lead - _need_after(self.fmt) + 1
        hi = lead - self.fmt.frame_len
        if lead >= self.fmt.frame_len and hi >= t_lo:
            tail = self._state.tail
            out = chain_tail(tail.tail_re, tail.tail_im, self.fmt,
                             self.code, self.k, crc=self.crc,
                             labeling=self._labeling, commit_lo=t_lo,
                             commit_hi=hi)
            # The tail rows are the last `lead` emitted rows: block
            # _blocks + 1 with pos - lead lands on the right symbols.
            out = out._replace(pos=out.pos - lead)
            out_frames += self._commit(out, self._blocks + 1)
        return out_frames

    def pop_frames(self) -> list[Frame]:
        out, self.frames = self.frames, []
        return out

    def set_cfo(self, freq) -> None:
        """New NCO frequencies (scalar or (C,), cycles/input sample) from
        the next block on.  The step is a phase discontinuity that the
        tracker and the per-frame UW rotation absorb within about numAvg
        symbols; frames in that window may fail the CRC (counted)."""
        if not self.acquire_cfo:
            raise ValueError("set_cfo needs acquire_cfo=True (the plain "
                             "chain has no NCO)")
        if self._state is None:
            raise ValueError("engine not warmed up yet")
        f = torch.from_numpy(np.array(np.broadcast_to(
            np.asarray(freq, np.float32), (self.channels,))))
        self._state = self._state._replace(
            front=self._state.front._replace(freq=f.to(self.device)))

    @property
    def cfo_estimates(self):
        """Per-channel NCO frequencies (cycles/input sample, numpy) with
        acquire_cfo on; None otherwise or before the warm-up."""
        if not self.acquire_cfo or self._state is None:
            return None
        return self._state.front.freq.cpu().numpy()

    # -- checkpoint/resume -------------------------------------------------

    @property
    def chain_state(self):
        """The current carry: a ChainState, or a FrontChainState with
        acquire_cfo on (None during warm-up).  Save it with
        utils.checkpoint.save_state; resume with
        :meth:`restore_chain_state`."""
        return self._state

    def restore_chain_state(self, state, *, base_symbols: int | None = None,
                            blocks_done: int = 0) -> None:
        """Resume from a carry (utils.checkpoint.load_state, or
        utils/interop from a JAX carry): a ChainState, or a FrontChainState
        for an acquire_cfo engine.  An exact mid-stream restart; staged
        samples and buffered frames from before are discarded.
        base_symbols / blocks_done restore the input-symbol clock of
        Frame.start (keep them in the checkpoint's ``extra``)."""
        want = FrontChainState if self.acquire_cfo else ChainState
        if not isinstance(state, want):
            raise ValueError(f"engine needs a {want.__name__} carry, got "
                             f"{type(state).__name__} (acquire_cfo "
                             f"mismatch)")
        tail = state.tail.tail_re
        lead = seam_lead(self.fmt)
        if tuple(tail.shape) != (lead, self.channels):
            raise ValueError(f"tail is {tuple(tail.shape)}, engine needs "
                             f"{(lead, self.channels)} (format/channel "
                             f"mismatch)")
        self._state = state
        self._clear_staging()
        self._blocks = int(blocks_done)
        if base_symbols is not None:
            self._base = int(base_symbols)

    def _clear_staging(self) -> None:
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        self._plane_re, self._plane_im, self._plane_rows = [], [], 0
        self._pending = []        # [(block_index, ChainOutputs)]
        self._finalized = False
        self.frames: list[Frame] = []

    def reset(self) -> None:
        self._state: ChainState | None = None
        self._clear_staging()
        self._blocks = 0          # chain blocks processed (post warm-up)
        self._base = 0            # input symbols consumed by warm-up
