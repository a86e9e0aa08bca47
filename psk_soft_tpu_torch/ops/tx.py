"""Transmit chain: bit mapping, frame assembly, pulse shaping (port of
``psk_soft_tpu/ops/tx.py``).

The matching modulator of the receive side, so links can be simulated and
regression-tested end to end: info bits -> (CRC) -> (scramble) -> (FEC
encode) -> (interleave) -> UW framing -> M-PSK symbols -> pulse shaping.
Every mapping is the exact inverse of the receive side's convention:

- **Bit labeling**: :func:`bits_to_symbols` inverts ops/slicers' mapping
  (LSB-first, sign-based quadrants for QPSK, phase k*2pi/M -> binary k for
  M >= 8), so sliced bits of the modulated symbols reproduce the input.
- **Constellation**: ops/framesync.psk_points (angle 2*pi*k/M, +pi/4 for
  QPSK).
- **Framing**: UW symbols verbatim, payload symbols from the coded bits,
  the receive order of FecFrameDecoder + FrameDescrambler inverted.

Host numpy throughout, as in the JAX package; the CRC, scrambler, encoder
and interleaver are the port's own (run on CPU tensors).  Outputs are
byte-equal to the JAX module's for the same arguments.
"""

from __future__ import annotations

import functools

import numpy as np

from . import slicers
from .framesync import FrameFormat, psk_points


@functools.lru_cache(maxsize=16)
def _bit_to_symbol_lut(m: int, labeling: str) -> np.ndarray:
    """(m,) int64: symbol index for each packed LSB-first bit code."""
    labels = slicers.bit_labels(m, labeling)
    nb = labels.shape[1]
    codes = (labels.astype(np.int64)
             * (1 << np.arange(nb, dtype=np.int64))).sum(axis=1)
    lut = np.zeros(m, np.int64)
    lut[codes] = np.arange(m)
    return lut


def bits_to_symbols(m: int, bits, labeling: str = "scd") -> np.ndarray:
    """(..., N*log2(m)) LSB-first bits -> (..., N) symbol indices.

    labeling="scd" (default) is the exact inverse of ops/slicers.slice_bits;
    labeling="gray" is the coded-transmission mapping
    (ops/slicers.bit_labels).
    """
    b = np.asarray(bits, np.int64)
    nb = int(np.log2(m))
    if b.shape[-1] % nb:
        raise ValueError(f"bit count {b.shape[-1]} not a multiple of "
                         f"log2(M)={nb}")
    grp = b.reshape(b.shape[:-1] + (-1, nb))
    codes = (grp * (1 << np.arange(nb, dtype=np.int64))).sum(axis=-1)
    return _bit_to_symbol_lut(m, labeling)[codes]


def symbols_to_iq(m: int, idx) -> np.ndarray:
    """Symbol indices -> unit-energy complex points (soft-port grid)."""
    return psk_points(np.asarray(idx).reshape(-1), m).reshape(
        np.asarray(idx).shape)


def build_frame(fmt: FrameFormat, info_bits, code=None, lfsr=None,
                crc=None, interleave_rows: int | None = None,
                labeling: str = "scd") -> np.ndarray:
    """Info bits -> one frame's symbol indices (UW + payload).

    ``info -> [append_crc] -> [additive scramble] -> [conv_encode] ->
    [interleave] -> bits_to_symbols``; the frame comes back out of
    FrameSyncer (+ FecFrameDecoder / FrameDescrambler / FrameCrcChecker)
    as ``info_bits`` exactly.
    """
    bits = np.asarray(info_bits, np.int8)
    if bits.ndim != 1:
        raise ValueError("info_bits must be 1-D")
    if crc is not None:
        from .crc import append_crc
        bits = append_crc(crc, bits)
    if lfsr is not None:
        from .scramble import additive_scramble
        bits = additive_scramble(lfsr, bits).numpy()
    if code is not None:
        from .fec import conv_encode
        bits = conv_encode(code, bits).numpy()
    if interleave_rows is not None:
        from .interleave import interleave
        bits = interleave(bits, interleave_rows).numpy()
    nb = int(np.log2(fmt.m))
    want = fmt.payload * nb
    if bits.size != want:
        raise ValueError(f"frame carries {want} payload bits "
                         f"({fmt.payload} symbols x {nb}); got {bits.size} "
                         f"after coding")
    payload = bits_to_symbols(fmt.m, bits, labeling)
    return np.concatenate([np.asarray(fmt.uw, np.int64), payload])


def frame_stream(fmt: FrameFormat, infos, starts, total: int,
                 code=None, lfsr=None, crc=None,
                 interleave_rows: int | None = None,
                 labeling: str = "scd",
                 fill=None, seed: int = 0) -> np.ndarray:
    """Symbol-index stream of length ``total`` with frames at ``starts``.

    ``fill`` fills between frames: None = random M-PSK (seeded), or an
    integer symbol index.  Frames must fit and must not overlap.
    """
    if fill is None:
        rng = np.random.default_rng(seed)
        out = rng.integers(0, fmt.m, total).astype(np.int64)
    else:
        out = np.full(total, int(fill), np.int64)
    last_end = -1
    for info, s0 in zip(infos, starts):
        if s0 <= last_end:
            raise ValueError(f"frame at {s0} overlaps the previous frame")
        if s0 < 0 or s0 + fmt.frame_len > total:
            raise ValueError(f"frame at {s0} does not fit in {total}")
        out[s0:s0 + fmt.frame_len] = build_frame(
            fmt, info, code=code, lfsr=lfsr, crc=crc,
            interleave_rows=interleave_rows, labeling=labeling)
        last_end = s0 + fmt.frame_len - 1
    return out


def shape(m: int, idx, sps, pulse: str = "rect", rrc_beta: float = 0.35,
          rrc_span: int = 8) -> np.ndarray:
    """Symbol indices -> pulse-shaped complex baseband.

    rect: each point repeated ``sps`` times (integer sps).  rrc: unit
    impulses on the symbol grid filtered by the receive matched filter's
    root-raised-cosine taps (ops/matched_filter.rrc_taps), so TX -> RX
    composes to a raised cosine.  Vectorized over leading (C, ...) axes.
    """
    pts = symbols_to_iq(m, idx)
    if pulse == "rect":
        return np.repeat(pts, int(sps), axis=-1).astype(np.complex64)
    if pulse != "rrc":
        raise ValueError(f"unknown pulse {pulse!r}")
    from .matched_filter import rrc_taps
    sps = int(sps)
    taps = np.asarray(rrc_taps(sps, rrc_beta, rrc_span), np.float64)
    lead = pts.shape[:-1]
    n = pts.shape[-1]
    up = np.zeros(lead + (n * sps,), np.complex128)
    up[..., ::sps] = pts
    flat = up.reshape(-1, n * sps)
    out = np.stack([np.convolve(row, taps, mode="same") for row in flat])
    return out.reshape(lead + (n * sps,)).astype(np.complex64)
