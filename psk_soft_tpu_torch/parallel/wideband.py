"""Mesh-sharded wideband channelization (port of
``psk_soft_tpu/parallel/wideband.py:1-50``).

The polyphase DFT bank (ops/channelizer.py) is embarrassingly parallel
along time: output row t reads only input rows t-(K-1) .. t, so sharding
the (B, C) branch-row axis over the mesh needs exactly one K-1-row halo
from the left neighbor (overlap-save, the same ppermute seam the demod's
timing window uses in parallel/sharded.py).  The FFT axis (channels) stays
shard-local -- no collective touches it.

Capture-to-bits then composes as: rows sharded over "time" -> channelize
(this module) -> (rows, C) planes -> the time+channel-sharded demod
(parallel/sharded_full.py) without re-sharding: both stages shard the same
row axis.  Plain PyTorch (the branch sum of ops/channelizer and
``torch.fft.fft``), as the JAX body is plain XLA.
"""

from __future__ import annotations

import torch

from ..ops.channelizer import _branch_sum
from .mesh import P, Mesh, axis_size, ppermute, shard_map


def make_sharded_channelize(taps, channels: int, mesh: Mesh,
                            axis: str = "time"):
    """One-shot channelizer over row-sharded wideband input.

    Returns ``run(z) -> y`` with z (B, C) complex64 wideband branch rows
    (the ``x.reshape(B, C)`` of a B*C-sample capture) split P(axis, None)
    and y (B, C) channel samples split the same way.  Matches
    ``channelize_block`` with a zero carry (seam test:
    tests/test_torch_parallel.py).
    """
    taps = torch.as_tensor(taps, dtype=torch.float32)
    K = taps.numel() // channels
    hpoly = taps.reshape(K, channels).to(torch.complex64)

    def body(z):
        n_sh = axis_size(axis)
        # left neighbor's last K-1 rows (first shard: zeros == fresh carry)
        perm = [(i, i + 1) for i in range(n_sh - 1)]
        halo = ppermute(z[z.shape[0] - (K - 1):], axis, perm)
        zz = torch.cat([halo, z])
        v = _branch_sum(hpoly.to(z.device), zz, z.shape[0], 1, 0)
        return torch.fft.fft(v, dim=-1)

    return shard_map(body, mesh, in_specs=P(axis, None),
                     out_specs=P(axis, None))
