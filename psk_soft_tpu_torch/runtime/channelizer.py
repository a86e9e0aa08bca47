"""Wideband front end: stage a single capture-rate stream, emit demod-bank
input blocks through the polyphase DFT channelizer (port of
``psk_soft_tpu/runtime/channelizer.py:25-136`` over ops/channelizer).

Ragged wideband arrivals stage on the host; the device sees fixed-shape
blocks.  The channelizer's (rows, C) output IS kernel B1's time-major plane
layout, so ``step_planes`` feeds FullKernelBatchEngine.push_planes with
planes already on the device: capture bytes to demodulated bits with no
host transpose and no device-to-host round trip on the steady path.

Deployment shape it replaces: a wideband capture fanned through an upstream
channelizer into C narrowband streams, each consumed by one instance of the
reference component (cpp/psk_soft.cpp serviceFunction is single-stream).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.channelizer import (channel_frequencies, channelize_block,
                               channelize_block_os2, channelizer_init,
                               channelizer_os2_init, prototype_taps)


class ChannelizerFrontEnd:
    """Streaming wideband -> C-channel splitter in front of a bank engine,
    on ``device`` ("cuda" unless the caller asks for the CPU).

    Push capture-rate complex64 samples in any chunking; pop fixed blocks
    of ``rows`` channel-rate samples as time-major planes (device) or a
    channel-major array (host).  Streaming is block-split invariant (the
    K-1 branch-row carry rides between calls).
    """

    def __init__(self, channels: int, taps_per_branch: int = 8,
                 beta: float = 9.0, cutoff_scale: float = 1.0,
                 oversample: int = 1, *, device="cuda"):
        if oversample not in (1, 2):
            raise ValueError(f"oversample must be 1 or 2, got {oversample}")
        self.channels = int(channels)
        self.taps_per_branch = int(taps_per_branch)
        # oversample=2: hop C/2 (channelize_block_os2) -- each channel
        # comes out at 2*fs/C so occupancy near the +-fs/(2C) band edge
        # survives; pair with ResamplerBank (or sps*2) downstream.
        self.oversample = int(oversample)
        self.device = torch.device(device)
        self._taps = torch.from_numpy(
            prototype_taps(channels, taps_per_branch, beta=beta,
                           cutoff_scale=cutoff_scale)).to(self.device)
        self._carry = self._fresh_carry()
        self._staged: list[np.ndarray] = []
        self._staged_n = 0

    def _fresh_carry(self) -> torch.Tensor:
        init = channelizer_os2_init if self.oversample == 2 \
            else channelizer_init
        return init(self.channels, self.taps_per_branch, self.device)

    def push(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.complex64).ravel()
        if x.size:
            self._staged.append(x)
            self._staged_n += x.size

    def available_rows(self) -> int:
        """Channel-rate rows ready to emit."""
        return self._staged_n // self.channels * self.oversample

    def _take(self, n: int) -> np.ndarray:
        out = np.empty(n, np.complex64)
        got = 0
        while got < n:
            s = self._staged[0]
            take = min(s.size, n - got)
            out[got:got + take] = s[:take]
            if take == s.size:
                self._staged.pop(0)
            else:
                self._staged[0] = s[take:]
            got += take
        self._staged_n -= n
        return out

    def _channelize(self, rows: int) -> torch.Tensor:
        if rows % self.oversample:
            raise ValueError(f"rows must be a multiple of "
                             f"oversample={self.oversample}")
        x = torch.from_numpy(
            self._take(rows // self.oversample * self.channels)).to(
                self.device)
        step = channelize_block_os2 if self.oversample == 2 \
            else channelize_block
        self._carry, y = step(self._taps, self._carry, x)
        return y

    def step_planes(self, rows: int):
        """(re, im) contiguous float32 planes of shape (rows, C) on the
        device, or None if fewer than ``rows`` rows are staged -- plug
        straight into FullKernelBatchEngine.push_planes."""
        if self.available_rows() < rows:
            return None
        y = self._channelize(rows)
        return y.real.contiguous(), y.imag.contiguous()

    def step_block(self, rows: int):
        """Channel-major (C, rows) complex64 host array, or None -- the
        BatchEngine.push_block form."""
        if self.available_rows() < rows:
            return None
        return np.ascontiguousarray(self._channelize(rows).T.cpu().numpy())

    def drain(self, planes: bool = True):
        """Emit every remaining full row at EOS (a trailing partial row --
        fewer than C wideband samples -- cannot form an output sample and
        is dropped, like the reference's sub-symbol tail)."""
        rows = self.available_rows()
        if not rows:
            return None
        return self.step_planes(rows) if planes else self.step_block(rows)

    def reset(self) -> None:
        """Clear staging and filter history (upstream flush semantics)."""
        self._carry = self._fresh_carry()
        self._staged = []
        self._staged_n = 0

    def frequencies(self, xdelta: float) -> np.ndarray:
        """Channel center frequencies for an input sample spacing."""
        return channel_frequencies(self.channels, xdelta)
