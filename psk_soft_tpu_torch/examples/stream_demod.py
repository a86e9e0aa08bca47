"""Single-stream demodulation with full service semantics.

The closest drop-in for one instance of the reference REDHAWK component:
packets in (SRI + timestamps + EOS), four ports out, live reconfigure.

    python -m psk_soft_tpu_torch.examples.stream_demod [--device cpu]
"""

import sys

import numpy as np

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.examples import parse_device
from psk_soft_tpu_torch.runtime.engine import StreamEngine
from psk_soft_tpu_torch.runtime.streams import (SRI, Packet, PORT_BITS,
                                                PORT_SOFT)
from psk_soft_tpu_torch.testing.signals import gen_psk_channel


def main(argv=None) -> int:
    device = parse_device(__doc__, argv)
    if device is None:
        return 2
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
    eng = StreamEngine(cfg, block_symbols=256, device=device)

    # A QPSK burst with a small carrier offset and real noise.
    x, syms = gen_psk_channel(4000, sps=8, m=4, snr_db=20.0,
                              freq_offset=1e-4, seed=1)
    sri = SRI(stream_id="example", xdelta=1.0 / 1e6, mode=1)  # 1 Msps

    # Feed it as a packet stream, 5000 samples at a time.
    out_soft = []
    for i in range(0, x.size, 5000):
        chunk = x[i: i + 5000].astype(np.complex64)
        eos = i + 5000 >= x.size
        pkts = eng.process(Packet(data=chunk, sri=sri,
                                  t=i * sri.xdelta, eos=eos))
        if PORT_SOFT in pkts:
            p = pkts[PORT_SOFT]
            out_soft.append(p.data)
            print(f"t={p.t * 1e3:8.3f} ms  {p.data.size:4d} symbols, "
                  f"{pkts[PORT_BITS].data.size} bits"
                  + ("  [EOS]" if p.eos else ""))

    soft = np.concatenate(out_soft)
    # QPSK decisions sit at (+-1 +-1j)/sqrt(2) after the +pi/4 rotation.
    err = np.abs(np.abs(soft.real) - 2 ** -0.5).mean()
    print(f"\n{soft.size} symbols total; mean |I|-deviation from "
          f"1/sqrt(2): {err:.4f}")
    print("metrics:", eng.metrics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
