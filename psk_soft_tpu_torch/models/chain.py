"""The receive chain: demod -> frame sync -> Viterbi -> CRC
(port of ``psk_soft_tpu/models/chain.py:58-342``).

Stages, each on the planes' device:

- kernel B1 through ``models/full.demod_block_full``,
- the time-major fixed-capacity frame sync
  (``ops/framesync.sync_extract_topk_tm``, per-channel total peak ``count``),
- max-log PSK LLRs (``ops/fec.psk_llrs``),
- Viterbi through ``ops/cuda/viterbi_kernel.viterbi_decode_kernel`` (kernel
  B2 at frame lengths),
- an optional CRC check (``ops/crc.crc_bits``).

**Seam-correct streaming.**  The chain step carries the last
``seam_lead(fmt)`` soft rows across blocks and positions the sync commit
window so every stream position is committable in exactly one step, with
full local-max context on both sides: frames that straddle a block
boundary are decoded once, never dropped and never duplicated.  The stream
is treated as preceded by ``seam_lead(fmt)`` zero symbols (zero energy, no
peaks).  Reported ``pos`` is relative to the current block's first soft
row; negative values mean the frame started in the previous block.

**Front chain** (``make_front_chain_fn``): NCO derotation
(``ops/mixer.derotate``, per-channel carrier removal for offsets beyond the
M-th-power tracker's pull-in) and an optional AGC (``ops/agc.agc_block_tm``)
run on the (T, C) input planes ahead of kernel B1; the NCO frequency and
phase and the AGC power ride in the carried ``FrontState``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import DemodConfig
from ..ops.crc import CrcSpec, crc_bits
from ..ops.cuda.viterbi_kernel import viterbi_decode_kernel
from ..ops.fec import ConvCode, info_bits_for, psk_llrs
from ..ops.framesync import FrameFormat, sync_extract_topk_tm
from .full import demod_block_full


class ChainOutputs(NamedTuple):
    """Per-block decoded frames, fixed capacity k per channel.

    Rows where ``found`` is False are garbage (the fixed-capacity contract
    of sync_extract_topk).  ``count`` is the total number of committable
    peaks per channel including any beyond capacity: ``count > k`` means
    the cap dropped frames."""

    msg: torch.Tensor      # (C, k, n_msg) int8 decoded message bits
    ok: torch.Tensor       # (C, k) bool CRC pass (all True when no CRC)
    found: torch.Tensor    # (C, k) bool frame detected
    pos: torch.Tensor      # (C, k) int32 UW start (demod-output symbols;
    #                        seam chain: relative to the current block's
    #                        first row, negative = started last block)
    ang: torch.Tensor      # (C, k) float32 raw UW correlation angle
    count: torch.Tensor    # (C,) int32 total committable peaks


def chain_msg_bits(fmt: FrameFormat, code: ConvCode,
                   crc: CrcSpec | None) -> int:
    """Message bits per frame after FEC (and CRC field, if any)."""
    nb = int(np.log2(fmt.m))
    n_info = info_bits_for(code, fmt.payload * nb)
    return n_info - (crc.degree if crc is not None else 0)


def chain_tail(soft_re: torch.Tensor, soft_im: torch.Tensor,
               fmt: FrameFormat, code: ConvCode, k_frames: int,
               crc: CrcSpec | None = None, labeling: str = "gray", *,
               commit_lo: int | None = None,
               commit_hi: int | None = None) -> ChainOutputs:
    """Post-demod chain: (S, C) float32 soft planes -> decoded frames.
    Default commit window = one-shot containment; the seam chain passes
    explicit bounds (see :func:`make_seam_tail_fn`).  Every one of the
    C * k_frames rows is decoded, found or not."""
    nb = int(np.log2(fmt.m))
    n_info = info_bits_for(code, fmt.payload * nb)
    n_msg = n_info - (crc.degree if crc is not None else 0)
    c_dim = soft_re.shape[1]
    sync = sync_extract_topk_tm(soft_re, soft_im, fmt, k_frames,
                                commit_lo=commit_lo, commit_hi=commit_hi)
    n_rows = c_dim * k_frames
    llr = psk_llrs(fmt.m, sync.payloads.reshape(n_rows, fmt.payload),
                   labeling=labeling)
    bits = viterbi_decode_kernel(code, llr.reshape(n_rows, fmt.payload * nb))
    msg = bits[:, :n_msg]
    if crc is not None:
        ok = torch.all(crc_bits(crc, msg) == bits[:, n_msg:], dim=-1)
    else:
        ok = torch.ones((n_rows,), dtype=torch.bool, device=bits.device)
    return ChainOutputs(msg.reshape(c_dim, k_frames, n_msg),
                        ok.reshape(c_dim, k_frames), sync.found, sync.pos,
                        sync.ang, sync.count)


# --- seam-carrying streaming tail -------------------------------------------

def _need_after(fmt: FrameFormat) -> int:
    """Rows that must exist at/after a peak before it is final: the
    payload span and the right local-max window (norm through t+sep-1,
    i.e. soft through t+sep+uw-2)."""
    return max(fmt.frame_len, fmt.separation + fmt.uw_len - 1)


def seam_lead(fmt: FrameFormat) -> int:
    """Soft rows the seam chain carries across blocks: ``need_after +
    sep - 2``, so the commit window's left edge keeps its full ``sep - 1``
    look-back context inside the carried planes."""
    return _need_after(fmt) + fmt.separation - 2


def commit_bounds(fmt: FrameFormat, s_block: int) -> tuple[int, int]:
    """Commit window [lo, hi] (inclusive) in extended-plane coordinates
    for one block of ``s_block`` soft rows behind a ``seam_lead`` tail.
    Consecutive blocks' windows tile the stream exactly."""
    lead = seam_lead(fmt)
    na = _need_after(fmt)
    return lead - na + 1, lead + s_block - na


class SeamTailState(NamedTuple):
    """Carried soft rows: the last ``seam_lead(fmt)`` rows of the
    demodulated stream (time-major planes, the kernel's layout)."""

    tail_re: torch.Tensor   # (seam_lead, C) float32
    tail_im: torch.Tensor


def seam_tail_init(fmt: FrameFormat, channels: int, device,
                   dtype=torch.float32) -> SeamTailState:
    """Zero lead on ``device``: the stream is treated as preceded by
    ``seam_lead`` zero symbols (zero energy, no peaks of their own)."""
    lead = seam_lead(fmt)
    return SeamTailState(
        torch.zeros((lead, channels), dtype=dtype, device=device),
        torch.zeros((lead, channels), dtype=dtype, device=device))


def make_seam_tail_fn(fmt: FrameFormat, code: ConvCode, k_frames: int,
                      crc: CrcSpec | None = None, *,
                      labeling: str = "gray"):
    """Seam-correct post-demod chain step over (S, C) soft planes.

    Returns ``step(tail, soft_re, soft_im) -> (tail', ChainOutputs)``:
    syncs over [carried tail; block], commits exactly the positions whose
    detection is final this block, decodes them, and carries the new tail.
    ``pos`` is relative to the block's first row.  Blocks of any length
    >= 1."""
    lead = seam_lead(fmt)

    def step(tail: SeamTailState, soft_re, soft_im):
        s_out = soft_re.shape[0]
        ext_re = torch.cat([tail.tail_re, soft_re])
        ext_im = torch.cat([tail.tail_im, soft_im])
        lo, hi = commit_bounds(fmt, s_out)
        out = chain_tail(ext_re, ext_im, fmt, code, k_frames, crc=crc,
                         labeling=labeling, commit_lo=lo, commit_hi=hi)
        out = out._replace(pos=out.pos - lead)
        return SeamTailState(ext_re[s_out:], ext_im[s_out:]), out

    return step


class ChainState(NamedTuple):
    """Seam chain carry: demod state + the carried soft tail."""

    demod: Any              # models/full.FullState
    tail: SeamTailState


def chain_init(fmt: FrameFormat, channels: int, demod_state) -> ChainState:
    """Wrap a converged demod state (models/full.full_from_ff) for the
    seam chain step, on the demod state's device."""
    return ChainState(demod_state, seam_tail_init(
        fmt, channels, demod_state.planes.device))


def make_chain_fn(cfg: DemodConfig, fmt: FrameFormat, code: ConvCode,
                  k_frames: int, crc: CrcSpec | None = None, *,
                  labeling: str = "gray", debug_ports: bool = False,
                  seam: bool = True):
    """Build the chain step: kernel B1, then the tail.

    seam=True (the streaming contract): ``step(state, x_re, x_im) ->
    (state', ChainOutputs)`` with ``state`` a :class:`ChainState` (build
    via :func:`chain_init`); frames may straddle block boundaries and each
    is decoded once, in the step whose commit window holds its start.

    seam=False (one-shot): ``state`` is the bare demod FullState and each
    block is synced on its own under the containment rule (frames not
    wholly inside a block's demod output are not seen).

    ``x_re/x_im`` are (S*sps, C) time-major float32 input planes.
    """
    def demod(state, x_re, x_im):
        return demod_block_full(cfg, state, x_re, x_im,
                                debug_ports=debug_ports)

    if not seam:
        def step(state, x_re, x_im):
            st2, fo = demod(state, x_re, x_im)
            return st2, chain_tail(fo.soft_re, fo.soft_im, fmt, code,
                                   k_frames, crc=crc, labeling=labeling)

        return step

    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling=labeling)

    def step(state: ChainState, x_re, x_im):
        st2, fo = demod(state.demod, x_re, x_im)
        tail2, out = tail_step(state.tail, fo.soft_re, fo.soft_im)
        return ChainState(st2, tail2), out

    return step


# --- front-end stages ahead of the demod ------------------------------------

class FrontState(NamedTuple):
    """Carried front-end state: the NCO phase (continuous across blocks,
    so derotation never jumps) and frequency, and the AGC power EMA."""

    freq: torch.Tensor    # (C,) float32 NCO frequency, cycles/input sample
    phase: torch.Tensor   # (C,) float32 NCO phase at the block head, rad
    agc: Any              # ops/agc.AgcState, or None without an AGC


class FrontChainState(NamedTuple):
    front: FrontState
    demod: Any              # models/full.FullState
    tail: SeamTailState


def front_chain_init(fmt: FrameFormat, channels: int, demod_state, *,
                     agc_cfg=None, freq=None) -> FrontChainState:
    """Wrap a converged demod state for :func:`make_front_chain_fn`, on
    the demod state's device.

    freq: (C,) NCO frequencies in cycles/input sample (e.g. from
    eval/cfo.acquire_cfo); zeros when only the AGC is wanted.
    """
    from ..ops.agc import agc_init

    dev = demod_state.planes.device
    f = (torch.zeros((channels,), dtype=torch.float32, device=dev)
         if freq is None
         else torch.as_tensor(freq, dtype=torch.float32, device=dev))
    agc = agc_init(agc_cfg, channels, dev) if agc_cfg is not None else None
    front = FrontState(freq=f, phase=torch.zeros((channels,),
                                                 dtype=torch.float32,
                                                 device=dev), agc=agc)
    return FrontChainState(front, demod_state,
                           seam_tail_init(fmt, channels, dev))


def make_front_chain_fn(cfg: DemodConfig, fmt: FrameFormat, code: ConvCode,
                        k_frames: int, crc: CrcSpec | None = None, *,
                        agc_cfg=None, labeling: str = "gray",
                        debug_ports: bool = False):
    """The seam chain with the front end ahead of kernel B1: NCO
    derotation, then the optional AGC, then demod, sync, Viterbi and CRC as
    in :func:`make_chain_fn` (seam mode).

    Returns ``step(state, x_re, x_im) -> (state', ChainOutputs)`` with
    ``state`` a :class:`FrontChainState` (build via
    :func:`front_chain_init`).  The NCO frequency lives in the state, so a
    new estimate is a new state, not a new function.
    """
    from ..ops.agc import agc_block_tm
    from ..ops.mixer import derotate

    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling=labeling)

    def step(state: FrontChainState, x_re, x_im):
        fr = state.front
        y_re, y_im, phase2 = derotate(x_re, x_im, fr.freq, fr.phase)
        agc2 = fr.agc
        if agc_cfg is not None:
            agc2, y_re, y_im, _ = agc_block_tm(agc_cfg, fr.agc, y_re, y_im)
        st2, fo = demod_block_full(cfg, state.demod, y_re, y_im,
                                   debug_ports=debug_ports)
        tail2, out = tail_step(state.tail, fo.soft_re, fo.soft_im)
        return FrontChainState(FrontState(fr.freq, phase2, agc2), st2,
                               tail2), out

    return step
