"""Streaming demod engines, the service-loop equivalent: the stable import
surface (port of ``psk_soft_tpu/runtime/engine.py``).

The reference's ``serviceFunction`` (C4, ``cpp/psk_soft.cpp:346-618``) is a
blocking packet loop: getPacket -> flush/mode/reset checks -> property
snapshot -> SRI propagation -> hot loop -> four pushPackets.  Here the same
contract is a host-side engine around a block step on the engine's device:

* :class:`StreamEngine` -- one stream, full reference semantics;
  :class:`StreamRegistry` routes streamIDs to them;
* :class:`BatchEngine` -- C aligned streams as one batched step, and
  :class:`GroupEngine` over banks of mixed configs;
* :class:`FullKernelBatchEngine`, :class:`MixedKernelBatchEngine` and
  :class:`ChainEngine` -- the kernel-B1 banks and the receive chain.

Blocks are fixed-size (``block_symbols``); the sub-block remainder waits in
a host staging buffer.  On EOS the remaining whole symbols are processed as
one final shorter block and the tail < sps samples are dropped, like the
reference's never-completed last window.
"""

from .engine_stream import (EngineMetrics, _PipelineOps, StreamEngine,
                            StreamRegistry, logger, reconfigure_ff)
from .engine_bank import (BankAssembler, TMOutputs, _PipelinedPackets,
                          _merge_packet_dicts)
from .engine_batch import BatchEngine
from .engine_full import FullKernelBatchEngine
from .engine_mixed import MixedKernelBatchEngine
from .engine_group import GroupEngine
from .chain_engine import ChainEngine

__all__ = [
    "EngineMetrics", "StreamEngine", "StreamRegistry", "reconfigure_ff",
    "BankAssembler", "TMOutputs", "BatchEngine", "FullKernelBatchEngine",
    "MixedKernelBatchEngine", "GroupEngine", "ChainEngine", "logger",
]
