"""Descrambling stages of the receive chain (port of
``psk_soft_tpu/runtime/scramble.py``).

- :class:`FrameDescrambler`: frame-synchronous additive descrambling
  behind the frame layer; every popped frame's final bit payload
  (``info_bits`` when FEC decoded, else the sliced ``bits``) is XORed with
  the LFSR keystream re-seeded at the frame start, the whole drain in one
  GF(2) matrix product on the stage's device.
- :class:`StreamDescrambler`: self-synchronizing descrambling of a
  continuous per-channel bit stream with a max(taps)-bit history carry, so
  any block split equals one-shot descrambling.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.scramble import Lfsr, additive_scramble, selfsync_descramble


def _final_bits(frames: list):
    """(rows, use_info): the stacked final bit payloads of a drain."""
    use_info = frames[0].info_bits is not None
    return np.stack([f.info_bits if use_info else f.bits
                     for f in frames]), use_info


def _set_final_bits(frames: list, rows, use_info: bool) -> None:
    for f, row in zip(frames, rows):
        if use_info:
            f.info_bits = row
        else:
            f.bits = row


class FrameDescrambler:
    """Frame-synchronous additive descrambler behind the frame layer.

    Args:
      frames_src: a FrameSyncer / FecFrameDecoder (anything with
        ``pop_frames``); everything else delegates inward.
      lfsr: the keystream generator, re-seeded per frame.
      device: where the keystream product runs.
    """

    def __init__(self, frames_src, lfsr: Lfsr, *, device="cuda"):
        self.frames_src = frames_src
        self.lfsr = lfsr
        self.device = torch.device(device)
        self.frames_descrambled = 0

    def pop_frames(self) -> list:
        frames = self.frames_src.pop_frames()
        if not frames:
            return frames
        mat, use_info = _final_bits(frames)
        out = additive_scramble(self.lfsr,
                                torch.from_numpy(mat).to(self.device))
        _set_final_bits(frames, out.cpu().numpy(), use_info)
        self.frames_descrambled += len(frames)
        return frames

    def reset(self) -> None:
        self.frames_src.reset()

    def __getattr__(self, name):
        return getattr(self.frames_src, name)


class StreamDescrambler:
    """Self-synchronizing descrambler over (C, L) host bit blocks.

    y[n] = x[n] ^ x[n-t1] ^ ... with an exact per-channel history carry.
    Bits before the stream start are taken as 0; after a ``reset`` the
    first max(taps) outputs re-synchronize.
    """

    def __init__(self, channels: int, taps: tuple = (18, 23)):
        if min(taps) < 1:
            raise ValueError("tap delays must be >= 1")
        self.channels = int(channels)
        self.taps = tuple(int(t) for t in taps)
        self._d = max(self.taps)
        self._hist = np.zeros((self.channels, self._d), np.int8)

    def observe(self, bits) -> np.ndarray:
        x = np.asarray(bits, np.int8)
        if x.ndim != 2 or x.shape[0] != self.channels:
            raise ValueError(f"expected ({self.channels}, L) bit block; "
                             f"got {x.shape}")
        xx = np.concatenate([self._hist, x], axis=1)
        y = selfsync_descramble(torch.from_numpy(xx), self.taps).numpy()
        self._hist = np.ascontiguousarray(xx[:, xx.shape[1] - self._d:])
        return y[:, self._d:].astype(np.int8)

    def reset(self) -> None:
        self._hist[:] = 0
