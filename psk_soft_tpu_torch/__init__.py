"""psk_soft_tpu_torch: the PyTorch + CUDA port of psk_soft_tpu.

A second package beside the JAX reference, with the same module paths
(``psk_soft_tpu_torch/models/full.py`` <-> ``psk_soft_tpu/models/full.py``).
It imports torch, numpy and ctypes, never jax or psk_soft_tpu.  Plain tensor
work is PyTorch; every Pallas kernel of the JAX package is hand-written CUDA
C++ under ``csrc/`` (B1 the steady demod, B2-B4 the Viterbi decoder, B5 the
timing frontend), built with nvcc at first use.

Covered so far: the exact single-stream path (``models/psk``: the
exact-scan ``demod_block`` with ``DemodState``, ``make_demod_fn`` and
``demod_init``, as the JAX package exports them; ``runtime/engine``'s
``StreamEngine``, ``StreamRegistry``, ``BatchEngine`` and ``GroupEngine``),
the flagship bank engine (``runtime/engine_full.FullKernelBatchEngine``,
with configure, checkpoint restore and the non-finite guard) and the mixed
bank (``runtime/engine_mixed``), the receive chain
(``runtime/chain_engine.ChainEngine``, with carrier acquisition), the fused
pipeline (``models/fused``), the per-stage bit layer
(``runtime/receiver.build_receiver`` over ``runtime/{framesync,fec,
scramble,crc}``, and the streaming and time-parallel Viterbi decoders of
``ops/fec``), and the golden-vector generator and reference oracle
(``testing/``).
"""

from .config import DemodConfig
from .state import DemodState, init_state, reconfigure
from .models.psk import DemodOutputs, demod_block, demod_init, make_demod_fn

__version__ = "0.1.0"

__all__ = [
    "DemodConfig",
    "DemodState",
    "DemodOutputs",
    "init_state",
    "reconfigure",
    "demod_block",
    "demod_init",
    "make_demod_fn",
]
