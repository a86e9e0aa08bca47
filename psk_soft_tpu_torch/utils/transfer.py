"""Host <-> device transfer helpers (port of
``psk_soft_tpu/utils/transfer.py:24-83``).

The JAX package splits complex buffers into float32 planes at every
crossing, because its TPU runtime could not move complex64 in either
direction.  PyTorch moves complex64 tensors to and from a CUDA device like
any other dtype, so here each helper is one copy: no plane split, no
recombination.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def complex_zeros(shape, device="cuda") -> torch.Tensor:
    """complex64 zeros on ``device``."""
    return torch.zeros(shape, dtype=torch.complex64, device=device)


def complex_ones(shape, device="cuda") -> torch.Tensor:
    """complex64 ones (1+0j) on ``device``."""
    return torch.ones(shape, dtype=torch.complex64, device=device)


def to_device(x, device="cuda") -> torch.Tensor:
    """An array (or tensor) as a tensor on ``device``, dtype kept:
    complex64 uploads as complex64."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    # ascontiguousarray promotes 0-d to 1-d; reshape restores.
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)).to(
        device)


def to_host(tree):
    """Every tensor of a tree as a numpy array.  NamedTuples (a
    ``QuantSoft`` stays a ``QuantSoft``), dataclasses, dicts, lists and
    tuples keep their type; other leaves (None, scalars, arrays) pass
    through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, dict):
        return type(tree)((k, to_host(v)) for k, v in tree.items())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_host(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree
