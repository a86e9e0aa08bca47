"""Port parity, chain-level FER: psk_soft_tpu_torch/eval/coded.
measure_chain_fer (the port's chain: kernel B1's and B2's plain versions on
the CPU) against the JAX one with the Pallas kernels in interpret mode, at
tests/test_coded_ber.py's operating points, 128 channels (the JAX chain's
smallest channel count) and one block: the ChainFerPoint equal."""

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.eval import coded as jax_coded
from psk_soft_tpu.ops import crc as jax_crc
from psk_soft_tpu.ops import fec as jax_fec
from psk_soft_tpu.ops.framesync import FrameFormat as JaxFrameFormat
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.eval import coded
from psk_soft_tpu_torch.ops import crc, fec
from psk_soft_tpu_torch.ops.framesync import FrameFormat

torch.set_num_threads(1)

# tests/test_coded_ber.py's chain-FER operating points, one block each.
CHAIN_POINTS = {
    "12db_cfo": (12.0, dict(cfo=2e-5)),
    "8db": (8.0, {}),
    "-2db": (-2.0, {}),
    "12db_acquisition": (12.0, dict(front_cfo=0.02)),
}


def _chain_args():
    rng = np.random.default_rng(31)
    uw = tuple(int(v) for v in rng.integers(0, 4, 32))
    kw = dict(sps=8, num_avg=40, constellation_size=4, phase_avg=30)
    port = (DemodConfig(**kw), FrameFormat(uw=uw, payload=48, m=4,
                                           threshold=0.7),
            fec.CODE_K7, crc.CRC16_CCITT)
    jax = (JaxDemodConfig(**kw), JaxFrameFormat(uw=uw, payload=48, m=4,
                                                threshold=0.7),
           jax_fec.CODE_K7, jax_crc.CRC16_CCITT)
    return port, jax


@pytest.mark.parametrize("point", sorted(CHAIN_POINTS))
def test_measure_chain_fer_matches_jax(point):
    esn0, kw = CHAIN_POINTS[point]
    port, jax = _chain_args()
    got = coded.measure_chain_fer(*port, esn0, channels=128, blocks=1,
                                  seed=3, device="cpu", **kw)
    ref = jax_coded.measure_chain_fer(*jax, esn0, channels=128, blocks=1,
                                      seed=3, **kw)
    assert isinstance(got, coded.ChainFerPoint)
    assert tuple(got) == tuple(ref)
    assert got.fer == ref.fer


def test_measure_chain_fer_validation():
    port, _ = _chain_args()
    with pytest.raises(ValueError, match="num_avg"):
        coded.measure_chain_fer(*port, 10.0, rows=(20, 300), device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        coded.measure_chain_fer(*port, 10.0, cfo=1e-5, front_cfo=0.02,
                                device="cpu")
