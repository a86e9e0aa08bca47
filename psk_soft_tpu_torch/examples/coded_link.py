"""Complete coded link: TX chain -> channel -> RX chain, bit-exact.

Information bits travel the full production path:

    info -> PRBS15 scramble -> K=7 rate-1/2 convolutional encode
         -> UW framing -> QPSK -> rect pulses -> CFO + AWGN   (ops/tx.py)
    -> BatchEngine demod -> FrameSyncer (M-fold ambiguity resolved)
    -> FecFrameDecoder (batched Viterbi: kernel B2 on the GPU)
    -> FrameDescrambler -> the original info bits, exactly.

    python -m psk_soft_tpu_torch.examples.coded_link [--device cpu]
"""

import sys

import numpy as np

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.examples import parse_device
from psk_soft_tpu_torch.ops import tx
from psk_soft_tpu_torch.ops.fec import CODE_K7, info_bits_for
from psk_soft_tpu_torch.ops.framesync import FrameFormat
from psk_soft_tpu_torch.ops.scramble import prbs15
from psk_soft_tpu_torch.runtime.engine import BatchEngine
from psk_soft_tpu_torch.runtime.fec import FecFrameDecoder
from psk_soft_tpu_torch.runtime.framesync import FrameSyncer
from psk_soft_tpu_torch.runtime.scramble import FrameDescrambler
from psk_soft_tpu_torch.runtime.streams import SRI


def main(argv=None) -> int:
    device = parse_device(__doc__, argv)
    if device is None:
        return 2
    rng = np.random.default_rng(1)
    C, sps, S = 4, 8, 2600
    cfg = DemodConfig(sps=sps, num_avg=30, constellation_size=4,
                      phase_avg=40)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    lf = prbs15()
    n_info = info_bits_for(CODE_K7, fmt.payload * 2)   # 58 bits/frame

    # -- transmit ------------------------------------------------------------
    # Keep the last frame clear of the stream tail: the demod's warm-up
    # window (num_avg symbols) shifts the usable end of the soft stream.
    starts = list(range(400, S - fmt.frame_len - cfg.num_avg - 34, 350))
    truth, rows = {}, []
    for c in range(C):
        infos = [rng.integers(0, 2, n_info, np.int8) for _ in starts]
        for s0, info in zip(starts, infos):
            truth[(c, s0)] = info
        idx = tx.frame_stream(fmt, infos, starts, S, code=CODE_K7,
                              lfsr=lf, seed=10 + c)
        x = tx.shape(4, idx, sps)
        x = x * np.exp(2j * np.pi * (1.5e-4 * np.arange(x.size) + 0.2 * c))
        x = x + 0.05 * (rng.standard_normal(x.size)
                        + 1j * rng.standard_normal(x.size))
        rows.append(x.astype(np.complex64))
    wire = np.stack(rows)

    # -- receive -------------------------------------------------------------
    eng = BatchEngine(cfg, channels=C, block_symbols=256, device=device)
    eng.set_input_sri(SRI(stream_id="coded-link"))
    sync = FrameSyncer(eng, fmt, device=device)
    top = FrameDescrambler(FecFrameDecoder(sync, CODE_K7, device=device), lf,
                           device=device)
    block = 256 * sps
    pos = 0
    while pos < wire.shape[1]:
        for c in range(C):
            sync.push(c, wire[c, pos:pos + block])
        top.step_packets()
        pos += block
    top.flush_packets()                      # drains the sub-block tail
    frames = top.pop_frames()

    exact = sum(np.array_equal(f.info_bits, truth[(f.channel, f.start)])
                for f in frames)
    print(f"frames synced/decoded: {len(frames)} "
          f"(expected {C * len(starts)})")
    print(f"info payloads exact:   {exact}/{len(frames)}")
    print(f"channel errors the code absorbed: "
          f"{sum(f.corrected for f in frames)}")
    assert exact == len(frames) == C * len(starts)
    print("coded link closed bit-exactly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
