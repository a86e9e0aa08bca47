"""psk_soft_tpu_torch: the PyTorch + CUDA port of psk_soft_tpu.

A second package beside the JAX reference, with the same module paths
(``psk_soft_tpu_torch/models/full.py`` <-> ``psk_soft_tpu/models/full.py``).
It imports torch, numpy and ctypes, never jax or psk_soft_tpu.  Plain tensor
work is PyTorch; every Pallas kernel of the JAX package is hand-written CUDA
C++ under ``csrc/`` (B1 the steady demod, B2-B4 the Viterbi decoder, B5 the
timing frontend), built with nvcc at first use.

Covered so far: the flagship bank engine
(``runtime/engine_full.FullKernelBatchEngine``, with configure, checkpoint
restore and the non-finite guard), the receive chain
(``runtime/chain_engine.ChainEngine``, with carrier acquisition), and the
fused pipeline (``models/fused``).
"""

from .config import DemodConfig

__version__ = "0.1.0"

__all__ = ["DemodConfig"]
