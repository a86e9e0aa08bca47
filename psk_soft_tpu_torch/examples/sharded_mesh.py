"""Multi-shard demodulation over a (channel x time) mesh.

One stream's TIME axis shards across the mesh (halo exchange + prefix
combine at seams) while channels shard communication-free -- the scaling
axes of BASELINE.md.  ``--shards`` shards of the device (default: every
CUDA device, one per shard; 8 with ``--device cpu``, the JAX package's
virtual CPU mesh); shards may share a device.

    python -m psk_soft_tpu_torch.examples.sharded_mesh [--device cpu]
        [--shards N]
"""

import sys

import numpy as np
import torch

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.examples import parse_args
from psk_soft_tpu_torch.parallel.mesh import make_mesh, shard_devices
from psk_soft_tpu_torch.parallel.sharded import make_sharded_demod
from psk_soft_tpu_torch.utils.transfer import to_device, to_host


def main(argv=None) -> int:
    args = parse_args(__doc__, argv, lambda ap: ap.add_argument(
        "--shards", type=int, default=None,
        help="shards of the mesh (default: the CUDA device count; 8 on the "
             "cpu)"))
    if args is None:
        return 2
    device = torch.device(args.device)
    n = args.shards or (8 if device.type == "cpu"
                        else torch.cuda.device_count())
    chan, time = (2, n // 2) if n % 2 == 0 and n > 1 else (1, n)
    mesh = make_mesh(chan=chan, time=time,
                     devices=shard_devices(device, n))
    platform = "gpu" if device.type == "cuda" else device.type
    print(f"devices: {n} ({platform}), mesh: chan={chan} x time={time}")

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    C, S = 16, 1024          # 16 channels, 1024 symbols split over `time`
    rng = np.random.default_rng(0)
    pts = np.exp(2j * np.pi * rng.integers(0, 4, (C, S)) / 4)
    # Timing-decisive pulses (energy on intra-symbol index 3): rectangular
    # pulses carry no timing information, so the windowed argmax ties and
    # different-but-equally-valid decisions appear across shardings
    # (PARITY.md "tie sensitivity").
    x = np.zeros((C, S * cfg.sps), np.complex64)
    x[:, 3::cfg.sps] = pts * np.exp(
        2j * np.pi * 2e-4 * cfg.sps * np.arange(S))[None]
    x += (0.005 * rng.standard_normal(x.shape)).astype(np.complex64)

    fn = make_sharded_demod(cfg, mesh, total_symbols=S)
    out = to_host(fn(to_device(x, device)))
    v = out.valid[0]
    print(f"{int(v.sum())} symbols/channel demodulated across the mesh")

    # Seam invariance: identical to the single-device feed-forward run.
    from psk_soft_tpu_torch.models.blockpsk import ff_init, make_ff_demod_fn
    ff = make_ff_demod_fn(cfg, channels=C)
    _, ref = ff(ff_init(cfg, C, device), to_device(x, device))
    ref = to_host(ref)
    err = np.abs(out.soft[:, v] - ref.soft[:, ref.valid[0]]).max()
    print(f"max |sharded - single-device| soft error: {err:.2e}")
    assert err < 1e-4
    return 0


if __name__ == "__main__":
    sys.exit(main())
