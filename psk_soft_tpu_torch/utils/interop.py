"""State carried between the JAX package and the port.

The demod has no learned weights; what crosses over is configuration and
carries.  Everything goes through numpy, so neither package imports the
other: the tests read the JAX NamedTuples into numpy dicts and hand them
here.  complex64 stays complex64.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..config import DemodConfig
from ..models.blockpsk import FFState
from ..models.full import FullState


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


def ff_state_from_numpy(arrays: Mapping, device) -> FFState:
    """FFState on ``device`` from a mapping of its fields (channels
    leading, e.g. the JAX channel-batched FFState's fields as numpy)."""
    return _from_numpy(FFState, arrays, device)


def full_state_from_numpy(arrays: Mapping, device) -> FullState:
    """FullState on ``device`` from a mapping of its fields."""
    return _from_numpy(FullState, arrays, device)


def ff_state_to_numpy(state: FFState) -> dict:
    return _to_numpy(state)


def full_state_to_numpy(state: FullState) -> dict:
    return _to_numpy(state)
