"""psk_soft_tpu_torch: the PyTorch + CUDA port of psk_soft_tpu.

A second package beside the JAX reference, with the same module paths
(``psk_soft_tpu_torch/models/full.py`` <-> ``psk_soft_tpu/models/full.py``).
It imports torch, numpy and ctypes, never jax or psk_soft_tpu.  Plain tensor
work is PyTorch; the steady-state demod kernel is hand-written CUDA C++
(``csrc/demod_full.cu``), built with nvcc at first use.

Slice covered so far: the flagship bank engine
(``runtime/engine_full.FullKernelBatchEngine``): feed-forward warm-up,
carry hand-off, the fused steady kernel, four-port packets.
"""

from .config import DemodConfig

__version__ = "0.1.0"

__all__ = ["DemodConfig"]
