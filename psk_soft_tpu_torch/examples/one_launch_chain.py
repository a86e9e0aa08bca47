"""The receive chain as one device step per block (models/chain.py).

Where examples/coded_link.py drives the per-stage streaming surface
(engine -> FrameSyncer -> FecFrameDecoder), this is the throughput path:
demod (kernel B1) -> time-major frame sync -> Viterbi (kernel B2) -> CRC,
composed into one step per block whose only host round trip is the
decoded-frame table.

    python -m psk_soft_tpu_torch.examples.one_launch_chain [--device cpu]
"""

import sys

import numpy as np
import torch

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.examples import parse_device
from psk_soft_tpu_torch.models.blockpsk import demod_block_ff, ff_init
from psk_soft_tpu_torch.models.chain import (chain_init, chain_msg_bits,
                                             make_chain_fn)
from psk_soft_tpu_torch.models.full import full_from_ff
from psk_soft_tpu_torch.ops import tx
from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
from psk_soft_tpu_torch.ops.fec import CODE_K7
from psk_soft_tpu_torch.ops.framesync import FrameFormat
from psk_soft_tpu_torch.utils.transfer import to_device

C, SPS, S = 128, 8, 512        # channels (the bank wants multiples of 128)


def main(argv=None) -> int:
    device = parse_device(__doc__, argv)
    if device is None:
        return 2
    cfg = DemodConfig(sps=SPS, num_avg=40, constellation_size=4,
                      phase_avg=30)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(1)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, code, crc)

    # TX: two CRC-protected, K=7-coded frames per block per channel.
    rows = [60, 300]                             # detection rows (output grid)
    starts = [r - (cfg.num_avg - 1) for r in rows]   # demod output lags input
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
    idx = tx.frame_stream(fmt, infos, starts, S, code=code, crc=crc,
                          labeling="gray", seed=2)
    x = np.repeat(np.exp(1j * (2 * np.pi * np.tile(idx, (C, 1)) / 4 + 0.3)),
                  SPS, axis=1).astype(np.complex64)
    x += 0.02 * (rng.standard_normal(x.shape)
                 + 1j * rng.standard_normal(x.shape)).astype(np.complex64)

    # Converge the tracker through the warm-up pipeline, hand off to kernel
    # B1, then run the whole chain as one step per block.
    st_ff, _ = demod_block_ff(cfg, ff_init(cfg, C, device),
                              to_device(x, device))
    state = chain_init(fmt, C, full_from_ff(cfg, st_ff))
    step = make_chain_fn(cfg, fmt, code, len(rows), crc=crc)
    x_re = torch.from_numpy(np.ascontiguousarray(x.real.T)).to(device)
    x_im = torch.from_numpy(np.ascontiguousarray(x.imag.T)).to(device)

    state, out = step(state, x_re, x_im)         # first block
    state, out = step(state, x_re, x_im)         # steady block
    found = out.found.cpu().numpy()
    ok = out.ok.cpu().numpy()
    msg = out.msg.cpu().numpy()
    assert found.all() and ok.all()
    assert np.array_equal(msg, np.tile(np.stack(infos), (C, 1, 1)))
    print(f"one-launch chain: {C} channels x {len(rows)} frames/block -- all "
          f"frames found at rows {out.pos[0].tolist()}, every CRC "
          f"green, {msg.size} message bits exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
