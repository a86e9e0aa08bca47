"""Symbol-timing recovery: windowed max-energy decision-sample selection
(port of ``psk_soft_tpu/ops/timing.py:32-144``).

For symbol-aligned data ``E[k, j] = |x[k*sps + j]|^2`` the bin state the
reference holds when input symbol ``k + numAvg - 1`` completes is

    W[k, j] = sum_{t=k}^{k+numAvg-1} E[t, j]

and output symbol k takes the first-max bin of row k (``std::max_element``
returns the first maximum; so does ``torch.argmax``).
"""

from __future__ import annotations

import torch


def symbol_energy_rows(xs: torch.Tensor) -> torch.Tensor:
    """Per-sample energy |x|^2 of (..., S, sps) complex rows, float32."""
    return (xs.real * xs.real + xs.imag * xs.imag).to(torch.float32)


def windowed_bin_sums(e_rows: torch.Tensor, num_avg: int) -> torch.Tensor:
    """Rolling sum of energy rows over a forward window of num_avg symbols,
    as cumsum-diff along axis -2.

    e_rows: (..., R, sps) energies for R = S + num_avg - 1 consecutive
    symbols.  Returns (..., S, sps) with W[o] = sum(e_rows[o:o+num_avg]).
    """
    if num_avg == 1:
        return e_rows
    s = e_rows.shape[-2] - (num_avg - 1)
    cs = torch.cumsum(e_rows, dim=-2)
    upper = cs[..., num_avg - 1:, :]
    lower = cs[..., : s - 1, :]
    zero = torch.zeros_like(upper[..., :1, :])
    return upper - torch.cat([zero, lower], dim=-2)


def select_decision_samples(s_rows: torch.Tensor, w: torch.Tensor):
    """First-max intra-symbol index of ``w`` and the decision sample of
    ``s_rows`` (both (..., S, sps)).  Returns (sample_index int32, sel)."""
    idx = torch.argmax(w, dim=-1)
    sel = torch.gather(s_rows, -1, idx.unsqueeze(-1)).squeeze(-1)
    return idx.to(torch.int32), sel
