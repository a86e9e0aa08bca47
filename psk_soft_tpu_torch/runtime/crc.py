"""CRC integrity stage behind the frame layer (port of
``psk_soft_tpu/runtime/crc.py``).

Drained frames' final bit payloads (``info_bits`` when FEC decoded, else
``bits``) are split into message || CRC, the CRC recomputed for the whole
drain in one GF(2) matrix product on the stage's device, ``crc_ok`` set per
frame and the CRC field stripped.  Stacks outside the descrambler:

    FrameCrcChecker(FrameDescrambler(FecFrameDecoder(FrameSyncer(...))))

matching the TX order info -> append_crc -> scramble -> encode -> frame.
"""

from __future__ import annotations

import torch

from ..ops.crc import CrcSpec, check_crc
from .scramble import _final_bits, _set_final_bits


class FrameCrcChecker:
    """Check and strip each frame's trailing CRC field.

    Args:
      frames_src: FrameSyncer / FecFrameDecoder / FrameDescrambler
        (anything with ``pop_frames``); everything else delegates inward.
      spec: the CRC (ops/crc presets: CRC16_CCITT / CRC32_MPEG2).
      device: where the CRC is computed.
    """

    def __init__(self, frames_src, spec: CrcSpec, *, device="cuda"):
        self.frames_src = frames_src
        self.spec = spec
        self.device = torch.device(device)
        self.frames_checked = 0
        self.crc_failures = 0

    def pop_frames(self) -> list:
        frames = self.frames_src.pop_frames()
        if not frames:
            return frames
        mat, use_info = _final_bits(frames)
        msgs, ok = check_crc(self.spec, mat, device=self.device)
        _set_final_bits(frames, msgs, use_info)
        for f, good in zip(frames, ok):
            f.crc_ok = bool(good)
        self.frames_checked += len(frames)
        self.crc_failures += int((~ok).sum())
        return frames

    def reset(self) -> None:
        self.frames_src.reset()

    def __getattr__(self, name):
        return getattr(self.frames_src, name)
