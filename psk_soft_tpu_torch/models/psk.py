"""Demod output record (port of ``psk_soft_tpu/models/psk.py:43-58``).

The exact-scan pipeline of the JAX module is a later ROADMAP step; the
slice needs only the output record shared by every pipeline.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DemodOutputs(NamedTuple):
    """Per-block outputs; the four reference output ports plus validity.
    Leading axes are channels (C, S, ...).

    soft:         (C, S) complex64  -- softDecision_dataFloat_out (or a
                                       models/full.QuantSoft)
    bits:         (C, S, 3) int8    -- bits_dataShort_out, LSB-first, only
                                       the first cfg.bits_per_symbol columns
                                       valid
    phase:        (C, S) float32    -- phase_dataFloat_out (or None)
    sample_index: (C, S) int        -- sampleIndex_dataShort_out (or None)
    valid:        (C, S) bool       -- warm-up gate; invalid rows are padding
    """

    soft: torch.Tensor
    bits: torch.Tensor
    phase: torch.Tensor | None
    sample_index: torch.Tensor | None
    valid: torch.Tensor
