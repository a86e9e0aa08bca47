"""State carried between the JAX package and the port.

The demod has no learned weights; what crosses over is configuration,
carries and a mixed bank's per-channel modes.  Everything goes through
numpy and plain dataclass fields, so neither package imports the other:
the tests read the JAX NamedTuples into numpy dicts (and the JAX
dataclasses through ``dataclasses.asdict``) and hand them here.  complex64
stays complex64.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..config import DemodConfig
from ..models.blockpsk import FFState
from ..models.chain import (ChainState, FrontChainState, FrontState,
                            SeamTailState)
from ..models.full import FullState
from ..models.fused import FusedState
from ..models.mixed import MixedParams
from ..ops.agc import AgcConfig, AgcState
from ..ops.crc import CrcSpec
from ..ops.equalizer import EqState
from ..ops.fec import ConvCode, ViterbiStreamState
from ..ops.framesync import FrameFormat
from ..state import DemodState


def config_from_jax_dict(d: Mapping) -> DemodConfig:
    """DemodConfig from ``dataclasses.asdict`` of the JAX DemodConfig."""
    return DemodConfig(**d)


def _from_numpy(cls, arrays: Mapping, device):
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise ValueError(f"{cls.__name__} fields missing: {sorted(missing)}")
    return cls(**{f: torch.from_numpy(np.array(arrays[f])).to(device)
                  for f in cls._fields})


def _to_numpy(state) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in state._fields}


def demod_state_from_numpy(arrays: Mapping, device) -> DemodState:
    """The exact scan's DemodState on ``device`` from a mapping of its
    fields (one chain, or channels leading; e.g. the JAX DemodState's
    fields as numpy)."""
    return _from_numpy(DemodState, arrays, device)


def demod_state_to_numpy(state: DemodState) -> dict:
    return _to_numpy(state)


def ff_state_from_numpy(arrays: Mapping, device) -> FFState:
    """FFState on ``device`` from a mapping of its fields (channels
    leading, e.g. the JAX channel-batched FFState's fields as numpy)."""
    return _from_numpy(FFState, arrays, device)


def full_state_from_numpy(arrays: Mapping, device) -> FullState:
    """FullState on ``device`` from a mapping of its fields."""
    return _from_numpy(FullState, arrays, device)


def fused_state_from_numpy(arrays: Mapping, device) -> FusedState:
    """FusedState on ``device`` from a mapping of its fields."""
    return _from_numpy(FusedState, arrays, device)


def mixed_params_from_numpy(m, diff, device) -> MixedParams:
    """A mixed bank's per-channel modes on ``device`` from the JAX
    MixedParams' fields as numpy ((C,) M and (C,) differential flags)."""
    return MixedParams.make(np.asarray(m), np.asarray(diff), device)


def fused_state_to_numpy(state: FusedState) -> dict:
    return _to_numpy(state)


def ff_state_to_numpy(state: FFState) -> dict:
    return _to_numpy(state)


def full_state_to_numpy(state: FullState) -> dict:
    return _to_numpy(state)


def viterbi_stream_state_from_numpy(arrays: Mapping,
                                    device) -> ViterbiStreamState:
    """The streaming decoder's carry on ``device`` from a mapping of its
    fields ((B, S) float32 pm, (D, B, S) bool dec; e.g. the JAX
    ViterbiStreamState's fields as numpy)."""
    return _from_numpy(ViterbiStreamState, arrays, device)


def viterbi_stream_state_to_numpy(state: ViterbiStreamState) -> dict:
    return _to_numpy(state)


def eq_state_from_numpy(arrays: Mapping, device) -> EqState:
    """The equalizer's carry on ``device`` from a mapping of its fields
    ((..., L) complex64 w, (..., L-1) complex64 hist; e.g. the JAX
    EqState's fields as numpy)."""
    return _from_numpy(EqState, arrays, device)


def eq_state_to_numpy(state: EqState) -> dict:
    return _to_numpy(state)


def frame_format_from_jax_dict(d: Mapping) -> FrameFormat:
    """FrameFormat from ``dataclasses.asdict`` of the JAX FrameFormat."""
    return FrameFormat(**d)


def conv_code_from_jax_dict(d: Mapping) -> ConvCode:
    """ConvCode from ``dataclasses.asdict`` of the JAX ConvCode."""
    return ConvCode(**d)


def crc_spec_from_jax_dict(d: Mapping) -> CrcSpec:
    """CrcSpec from ``dataclasses.asdict`` of the JAX CrcSpec."""
    return CrcSpec(**d)


def chain_state_from_numpy(demod: Mapping, tail: Mapping,
                           device) -> ChainState:
    """The seam chain carry on ``device``: ``demod`` maps the FullState
    fields (win_re, win_im, planes), ``tail`` the SeamTailState fields
    (tail_re, tail_im), e.g. the JAX ChainState's fields as numpy."""
    return ChainState(full_state_from_numpy(demod, device),
                      _from_numpy(SeamTailState, tail, device))


def chain_state_to_numpy(state: ChainState) -> dict:
    """{"demod": FullState fields, "tail": SeamTailState fields}."""
    return {"demod": _to_numpy(state.demod), "tail": _to_numpy(state.tail)}


def agc_config_from_jax_dict(d: Mapping) -> AgcConfig:
    """AgcConfig from ``dataclasses.asdict`` of the JAX AgcConfig."""
    return AgcConfig(**d)


def front_chain_state_from_numpy(front: Mapping, demod: Mapping,
                                 tail: Mapping, device) -> FrontChainState:
    """The front chain carry on ``device``: ``front`` maps freq, phase and
    agc (a mapping of the AgcState fields, or None without an AGC);
    ``demod`` and ``tail`` as in :func:`chain_state_from_numpy`."""
    agc = front.get("agc")
    fs = FrontState(
        freq=torch.from_numpy(np.array(front["freq"], np.float32)).to(device),
        phase=torch.from_numpy(np.array(front["phase"],
                                        np.float32)).to(device),
        agc=None if agc is None else _from_numpy(AgcState, agc, device))
    chain = chain_state_from_numpy(demod, tail, device)
    return FrontChainState(fs, chain.demod, chain.tail)


def front_chain_state_to_numpy(state: FrontChainState) -> dict:
    """{"front": {freq, phase, agc (dict or None)}, "demod": ..., "tail":
    ...} of numpy arrays."""
    fr = state.front
    return {"front": {"freq": fr.freq.cpu().numpy(),
                      "phase": fr.phase.cpu().numpy(),
                      "agc": None if fr.agc is None else _to_numpy(fr.agc)},
            **chain_state_to_numpy(state)}


def channelizer_carry_from_numpy(carry, device) -> torch.Tensor:
    """A channelizer's branch-row carry on ``device``: (K-1, C) complex64
    for ops/channelizer.channelize_block, (2K-1, C/2) for
    channelize_block_os2 (e.g. a JAX front end's carry as numpy), so a
    stream the JAX package started continues in the port."""
    a = np.array(carry, np.complex64)
    if a.ndim != 2:
        raise ValueError(f"channelizer carry must be 2-D, got {a.shape}")
    return torch.from_numpy(a).to(device)


def channelizer_carry_to_numpy(carry: torch.Tensor) -> np.ndarray:
    return carry.cpu().numpy()
