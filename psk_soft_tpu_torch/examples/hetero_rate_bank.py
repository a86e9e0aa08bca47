"""Heterogeneous-rate channel bank: fractional native bauds, one demod.

Four channels captured at a common rate but running different baud rates
(native sps 7.3, 8.0, 8.9, 9.25) are polyphase-resampled per channel to a
common sps-8 grid (runtime/resampler.py), then demodulated together in one
BatchEngine -- the capability the reference would need one component
deployment per rate for.

    python -m psk_soft_tpu_torch.examples.hetero_rate_bank [--device cpu]
"""

import sys

import numpy as np

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.examples import parse_device
from psk_soft_tpu_torch.ops.matched_filter import rrc_taps
from psk_soft_tpu_torch.runtime.engine import BatchEngine
from psk_soft_tpu_torch.runtime.resampler import ResamplerBank
from psk_soft_tpu_torch.testing.signals import sinc_interp
from psk_soft_tpu_torch.utils.transfer import to_host


def native_stream(nsym, native_sps, common_sps=8, seed=0):
    """RRC-shaped QPSK sampled at its native (fractional) rate."""
    rng = np.random.default_rng(seed)
    up = np.zeros((nsym + 16) * common_sps, np.complex128)
    up[::common_sps] = np.exp(2j * np.pi * rng.integers(0, 4, nsym + 16) / 4
                              + 1j * np.pi / 4)
    x8 = np.convolve(up, rrc_taps(common_sps, 0.35, 8).astype(np.float64),
                     mode="same")
    ratio = native_sps / common_sps          # native samples per common one
    n = int(nsym * common_sps * ratio)
    t = np.arange(n) / ratio                 # common-rate time of native m
    return sinc_interp(x8, t).astype(np.complex64)


def main(argv=None) -> int:
    device = parse_device(__doc__, argv)
    if device is None:
        return 2
    sps, nsym = 8, 360
    native = [7.3, 8.0, 8.9, 9.25]
    cfg = DemodConfig(sps=sps, num_avg=20, constellation_size=4,
                      phase_avg=10, matched_filter="rrc")

    bank = ResamplerBank([v / sps for v in native], block_out=64 * sps,
                         device=device)
    eng = BatchEngine(cfg, channels=len(native), block_symbols=64,
                      device=device)
    for c, v in enumerate(native):
        bank.push(c, native_stream(nsym, v, sps, seed=c))

    soft = [[] for _ in native]

    def pump(block):
        eng.push_block(block)
        while True:
            out = eng.step()
            if out is None:
                return
            out = to_host(out)
            for c in range(len(native)):
                soft[c].append(out.soft[c][out.valid[c]])

    while True:
        blk = bank.step()
        if blk is None:
            break
        pump(blk)
    for blk in bank.drain(planes=False):
        pump(blk)

    for c, v in enumerate(native):
        s = np.concatenate(soft[c])
        mid = s[16:-24]        # skip converging head + zero-padded EOS tail
        err = np.degrees(np.abs(np.angle(mid) % (np.pi / 2) - np.pi / 4))
        print(f"native sps {v:5.2f} -> common sps {sps}: {s.size} symbols, "
              f"angular error median {np.median(err):.2f} deg, "
              f"worst {err.max():.2f} deg (QPSK decision margin: 45)")
        # short tracking averages + RRC ISI put the worst soft decisions
        # around 10-20 deg off even at ratio 1.0; all decide correctly
        assert s.size > nsym - 120 and err.max() < 25.0
    print("hetero-rate bank demod OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
