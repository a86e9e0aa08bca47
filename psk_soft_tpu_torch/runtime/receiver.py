"""One-call receiver assembly (port of ``psk_soft_tpu/runtime/receiver.py``).

``build_receiver`` wires the receive chain in the canonical order (the
JAX CLI's ``demod-batch`` composition):

    AgcFrontEnd( EqFrontEnd( AutoCfoEngine( engine )))   <- sample side
    FrameCrcChecker( FrameDescrambler( FecFrameDecoder(
        FrameSyncer( StreamFecDecoder( QualityMonitor( ... ))))))

The sample side returns as ``rx.engine`` (push data into it, drive
``step_packets``/``flush_packets``); the frame side drains through
``rx.pop_frames()``.  Every stage is optional and omitted stages collapse
out of the stack.  Every stage and the engine run on ``device``; planes
pushed as tensors on it stay there through the front ends.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DemodConfig
from ..ops.framesync import FrameFormat


@dataclasses.dataclass
class Receiver:
    """The assembled stack.  ``engine`` ingests; ``frames`` drains."""

    engine: object                 # outermost sample-side stage (push here)
    frames: object | None          # outermost frame-side stage (pop here)
    quality: object | None = None  # QualityMonitor, if enabled
    syncer: object | None = None   # FrameSyncer, if enabled
    fec: object | None = None      # FecFrameDecoder, if enabled
    stream_fec: object | None = None

    def pop_frames(self) -> list:
        if self.frames is None:
            raise ValueError("receiver built without frame sync (uw=...)")
        return self.frames.pop_frames()

    def __getattr__(self, name):
        return getattr(self.engine, name)


def build_receiver(cfg: DemodConfig, channels: int, *,
                   engine: str = "batch", block_symbols: int = 1024,
                   agc: bool = False, equalize=None, acquire_cfo: bool = False,
                   quality: bool = False,
                   uw=None, frame_payload: int = 0, uw_threshold: float = 0.7,
                   fec=None, fec_interleave: int | None = None,
                   fec_labeling: str = "scd",
                   descramble=None, crc=None,
                   stream_fec=None,
                   engine_kwargs: dict | None = None,
                   device="cuda") -> Receiver:
    """Assemble a receive chain on ``device``.

    Args:
      engine: "batch" (runtime/engine_batch.BatchEngine), "full" (the
        kernel-B1 bank, FullKernelBatchEngine), or "chain" (ChainEngine:
        demod, seam sync, Viterbi and CRC per block; requires uw + fec,
        gray labeling and no per-stage wrappers).
      agc / equalize / acquire_cfo: sample-side front ends (``equalize``
        takes an ops.equalizer.EqConfig, or True for
        ``EqConfig(dd_m=M)``).
      quality: attach a QualityMonitor tap (it reads the soft packets, so
        it sees nothing with ``data_ports=False``).
      uw: unique-word symbol indices enabling frame sync.
      fec: ops.fec.ConvCode (frame payloads Viterbi-decoded).
      descramble: ops.scramble.Lfsr (frame-synchronous additive).
      crc: ops.crc.CrcSpec (checked and stripped per frame).
      stream_fec: ops.fec.ConvCode for continuous (unframed) decoding,
        exclusive with ``fec``.
      device: where the engine and every stage run ("cuda" unless the
        caller asks for the CPU).

    Returns a :class:`Receiver`.
    """
    from .engine_batch import BatchEngine
    from .engine_full import FullKernelBatchEngine

    def frame_format():
        return FrameFormat(
            uw=tuple(int(v) for v in np.asarray(uw).reshape(-1)),
            payload=frame_payload, m=cfg.constellation_size,
            threshold=uw_threshold)

    if engine == "chain":
        if uw is None or fec is None:
            raise ValueError("engine='chain' is the fused frame pipeline; "
                             "it requires uw=... and fec=...")
        if (agc or equalize or acquire_cfo or quality or descramble
                or stream_fec or fec_interleave):
            raise ValueError("engine='chain' composes demod+sync+FEC+CRC "
                             "per block; per-stage wrappers "
                             "(agc/equalize/cfo/quality/descramble/"
                             "interleave/stream_fec) need the per-stage "
                             "stack (engine='full')")
        if fec_labeling != "gray":
            raise ValueError("engine='chain' decodes gray-labeled "
                             "payloads (fec_labeling='gray')")
        from .chain_engine import ChainEngine
        eng = ChainEngine(cfg, channels, frame_format(), fec, crc,
                          block_symbols=block_symbols, device=device,
                          **(engine_kwargs or {}))
        return Receiver(engine=eng, frames=eng)

    kw = dict(engine_kwargs or {})
    if engine == "full":
        eng = FullKernelBatchEngine(cfg, channels,
                                    block_symbols=block_symbols,
                                    device=device, **kw)
    elif engine == "batch":
        eng = BatchEngine(cfg, channels, block_symbols=block_symbols,
                          device=device, **kw)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    if acquire_cfo:
        from .autocfo import AutoCfoEngine
        eng = AutoCfoEngine(eng)
    if equalize:
        from ..ops.equalizer import EqConfig
        from .equalizer import EqFrontEnd
        eq_cfg = (equalize if not isinstance(equalize, bool)
                  else EqConfig(dd_m=cfg.constellation_size))
        eng = EqFrontEnd(eng, eq_cfg)
    if agc:
        from ..ops.agc import AgcConfig
        from .agc import AgcFrontEnd
        eng = AgcFrontEnd(eng, AgcConfig(chunk=cfg.sps))

    qual = None
    if quality:
        from .quality import QualityMonitor
        eng = qual = QualityMonitor(eng)

    sfec = None
    if stream_fec is not None:
        if fec is not None:
            raise ValueError("fec (framed) and stream_fec (continuous) "
                             "decode the same bits two ways; pick one")
        from .fec import StreamFecDecoder
        eng = sfec = StreamFecDecoder(eng, stream_fec, labeling=fec_labeling,
                                      device=device)

    syncer = frames = fec_stage = None
    if uw is not None:
        from .framesync import FrameSyncer
        eng = syncer = frames = FrameSyncer(eng, frame_format(),
                                            device=device)
        if fec is not None:
            from .fec import FecFrameDecoder
            frames = fec_stage = FecFrameDecoder(
                syncer, fec, interleave_rows=fec_interleave,
                labeling=fec_labeling, device=device)
        if descramble is not None:
            from .scramble import FrameDescrambler
            frames = FrameDescrambler(frames, descramble, device=device)
        if crc is not None:
            from .crc import FrameCrcChecker
            frames = FrameCrcChecker(frames, crc, device=device)
    elif fec is not None or descramble is not None or crc is not None:
        raise ValueError("fec/descramble/crc are frame stages; they "
                         "require uw=... frame sync")

    # The frame-side wrappers tap packets through the sample side: route
    # step/flush through the outermost frame stage when present.
    top = frames if frames is not None else eng
    return Receiver(engine=top, frames=frames, quality=qual, syncer=syncer,
                    fec=fec_stage, stream_fec=sfec)
