"""The one traffic generator: a capture of a channel bank, built from
``--seed`` during set-up and replayed as a closed loop.

A traffic mix (``traffic/<mix>.json``) gives the parameters that differ
from ``DEFAULTS``, a configuration (``configs/<config>.json``) the widths;
nothing here is particular to a mix.  The capture is a pool of
``pool_blocks`` distinct blocks of ``block_symbols`` symbols on every
channel, one periodic stream: each channel's carrier offset turns a whole
number of times over the pool, so the stream continues seamlessly when the
pool repeats.

Per channel: M-PSK symbols with rectangular pulses of ``sps`` samples, unit
amplitude, a carrier offset of ``cfo_turns`` whole turns over the pool and a
random start phase, complex white noise of ``noise_std`` a component.  The
wire is time-major interleaved I/Q, float32 or int16 (``wire``), in host
memory, as a channelizer hands it over.

Symbols and noise come from a ``torch.Generator`` on the device in a few
calls a block; offsets and phases from a numpy generator on the host.  The
same seed gives the same pool on the same kind of device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Every mix's parameters unless its file says otherwise.  The path: entry
# (``paths/<entry>.py``), pipeline depth, wire and soft formats, blocks fed
# before the window, blocks the check keeps from the window, blocks traced
# after it.  The capture: blocks in the pool, noise a component, the range
# of whole carrier turns over the pool.
DEFAULTS = {
    "entry": "engine",
    "pipeline_depth": 1,
    "wire": "f32",
    "soft": "f32",
    "warmup_blocks": 8,
    "check_blocks": 48,
    "trace_blocks": 12,
    "pool_blocks": 32,
    "noise_std": 0.01,
    "cfo_turns": [-2, 2],
}


class Pool(NamedTuple):
    channels: int
    block_symbols: int
    sps: int
    blocks: int
    wire: np.ndarray          # (blocks * block_samples, C, 2) float32/int16
    scale: float | None       # int16 wire: volts a step

    @property
    def block_samples(self) -> int:
        return self.block_symbols * self.sps

    @property
    def period(self) -> int:
        """Symbols in one pass of the pool."""
        return self.blocks * self.block_symbols

    def block(self, b: int) -> np.ndarray:
        """Stream block ``b``'s wire samples: a (block_samples, C, 2)
        view."""
        n = self.block_samples
        j = b % self.blocks
        return self.wire[j * n:(j + 1) * n]

    def planes(self, b: int, dtype=torch.float64, device="cpu"):
        """Stream block ``b`` as channel-major (C, block_samples) re and
        im planes, int16 wire dequantized."""
        w = torch.from_numpy(self.block(b)).to(device)
        w = w.to(dtype)
        if self.scale is not None:
            w = w * self.scale
        return w[..., 0].T, w[..., 1].T


def make_pool(config: dict, traffic: dict, seed: int, device) -> Pool:
    """Build the capture of one cell for one seed."""
    dev = torch.device(device)
    c = int(config["channels"])
    s = int(config["block_symbols"])
    demod = config["demod"]
    sps, m = int(demod["sps"]), int(demod["constellation_size"])
    p = int(traffic["pool_blocks"])
    period = p * s
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    rng = np.random.default_rng(int(seed))

    idx = torch.randint(0, m, (c, period), generator=gen, device=dev)
    lo, hi = traffic["cfo_turns"]
    turns = torch.as_tensor(rng.integers(lo, hi + 1, c), device=dev)
    phase0 = torch.as_tensor(rng.uniform(0, 2 * math.pi, c), device=dev)
    noise = float(traffic["noise_std"])
    i16 = traffic["wire"] == "i16"
    scale = float(traffic["i16_full_scale"]) / 32767.0 if i16 else None
    n = s * sps
    wire = np.empty((p * n, c, 2), np.int16 if i16 else np.float32)
    for b in range(p):
        k = torch.arange(b * s, (b + 1) * s, device=dev, dtype=torch.int64)
        frac = (turns[:, None] * k[None, :]) % period
        ang = (2 * math.pi / m) * idx[:, b * s:(b + 1) * s] \
            + phase0[:, None] + (2 * math.pi / period) * frac
        pts = torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(
            torch.float32)                                # (C, S, 2)
        x = pts.transpose(0, 1).repeat_interleave(sps, dim=0)   # (n, C, 2)
        x = x + noise * torch.randn((n, c, 2), generator=gen, device=dev)
        if i16:
            x = torch.clamp(torch.round(x / scale), -32767, 32767).to(
                torch.int16)
        torch.from_numpy(wire[b * n:(b + 1) * n]).copy_(x)
    return Pool(c, s, sps, p, wire, scale)
