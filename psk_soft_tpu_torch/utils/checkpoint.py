"""Checkpoint / resume of carry states (port of
``psk_soft_tpu/utils/checkpoint.py:28-143``).

The reference restarts blind and re-converges over numAvg*sps samples; here
a carry is a NamedTuple of tensors, so a checkpoint is its leaves and a
resume is exact.

The file format is the JAX package's, so a checkpoint written by either
package loads in the other (ROADMAP A.10): an ``.npz`` with a JSON header
(``state_desc``, ``state_class``, ``config``, ``extra``) in ``__header__``;
complex leaves split into float32 ``<key>__re`` / ``<key>__im``; nested
states under dotted keys (``demod.win_re``); ``None`` fields (a disabled
AGC) recorded as such.  Pre-r5 flat files (``fields`` and
``complex_fields`` in the header) load too.  States are matched by class
name; every state class of the JAX package has its port here.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import DemodConfig

def _registry() -> dict:
    from ..models.blockpsk import FFState, SymbolBackendState
    from ..models.chain import (ChainState, FrontChainState, FrontState,
                                SeamTailState)
    from ..models.full import FullState
    from ..models.fused import FusedState
    from ..ops.agc import AgcState
    from ..ops.equalizer import EqState
    from ..ops.fec import ViterbiStreamState
    from ..state import DemodState

    return {cls.__name__: cls for cls in (
        DemodState, FFState, SymbolBackendState, FusedState, FullState,
        EqState, AgcState, SeamTailState, ChainState, FrontState, FrontChainState,
        ViterbiStreamState)}


def _state_class(name: str):
    reg = _registry()
    if name in reg:
        return reg[name]
    raise ValueError(f"unknown state class {name!r} in checkpoint")


def _is_state(x) -> bool:
    return hasattr(type(x), "_fields") and type(x).__name__ in _registry()


def _serialize(state, arrays: dict, prefix: str = "") -> dict:
    """Flatten a (possibly nested) state into ``arrays`` under dotted keys;
    returns the structure descriptor."""
    desc = {"class": type(state).__name__, "fields": {}}
    for name, leaf in zip(type(state)._fields, state):
        key = f"{prefix}{name}"
        if leaf is None:
            desc["fields"][name] = {"kind": "none"}
        elif _is_state(leaf):
            child = _serialize(leaf, arrays, key + ".")
            child["kind"] = "state"
            desc["fields"][name] = child
        else:
            leaf = torch.as_tensor(leaf).detach().cpu().numpy()
            if np.iscomplexobj(leaf):
                arrays[f"{key}__re"] = np.asarray(leaf.real, np.float32)
                arrays[f"{key}__im"] = np.asarray(leaf.imag, np.float32)
                desc["fields"][name] = {"kind": "complex"}
            else:
                arrays[key] = leaf
                desc["fields"][name] = {"kind": "array"}
    return desc


def _leaf(z, key: str, complex_: bool, device) -> torch.Tensor:
    if complex_:
        out = np.empty(z[f"{key}__re"].shape, np.complex64)
        out.real = z[f"{key}__re"]
        out.imag = z[f"{key}__im"]
    else:
        out = z[key]
    return torch.from_numpy(out).to(device)


def _deserialize(desc: dict, z, device, prefix: str = ""):
    cls = _state_class(desc["class"])
    leaves = []
    for name, fd in desc["fields"].items():
        key = f"{prefix}{name}"
        if fd["kind"] == "none":
            leaves.append(None)
        elif fd["kind"] == "state":
            leaves.append(_deserialize(fd, z, device, key + "."))
        else:
            leaves.append(_leaf(z, key, fd["kind"] == "complex", device))
    return cls(*leaves)


def save_state(path: str, state, cfg: DemodConfig,
               extra: dict | None = None) -> None:
    """Write a carry state (flat or nested, ``None`` fields allowed) and
    its config to ``path`` (.npz)."""
    arrays = {}
    desc = _serialize(state, arrays)
    header = {
        "state_desc": desc,
        "state_class": type(state).__name__,   # the flat format's key
        "config": dataclasses.asdict(cfg),
        "extra": extra or {},
    }
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, device):
    """Returns (state on ``device``, DemodConfig, extra); reads the nested
    format and pre-r5 flat checkpoints."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if "state_desc" in header:
            state = _deserialize(header["state_desc"], z, device)
        else:                                  # pre-r5 flat format
            cls = _state_class(header["state_class"])
            cplx = set(header["complex_fields"])
            state = cls(*(_leaf(z, name, name in cplx, device)
                          for name in header["fields"]))
    return state, DemodConfig(**header["config"]), header["extra"]
