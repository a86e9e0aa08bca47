"""Symbol-timing recovery: windowed max-energy decision-sample selection
(port of ``psk_soft_tpu/ops/timing.py:32-144``).

For symbol-aligned data ``E[k, j] = |x[k*sps + j]|^2`` the bin state the
reference holds when input symbol ``k + numAvg - 1`` completes is

    W[k, j] = sum_{t=k}^{k+numAvg-1} E[t, j]

and output symbol k takes the first-max bin of row k (``std::max_element``
returns the first maximum; so does ``torch.argmax``).
"""

from __future__ import annotations

import math

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


def windowed_bin_sums_direct(e_rows: torch.Tensor,
                             num_avg: int) -> torch.Tensor:
    """Reference windowed reduction (a sum over each window, no prefix
    sums); cross-checks the cumsum-diff path of :func:`windowed_bin_sums`,
    same shapes."""
    if num_avg == 1:
        return e_rows
    return e_rows.unfold(-2, num_avg, 1).sum(-1)


def select_decision_samples(s_rows: torch.Tensor, w: torch.Tensor):
    """First-max intra-symbol index of ``w`` and the decision sample of
    ``s_rows`` (both (..., S, sps)).  Returns (sample_index int32, sel)."""
    idx = torch.argmax(w, dim=-1)
    sel = torch.gather(s_rows, -1, idx.unsqueeze(-1)).squeeze(-1)
    return idx.to(torch.int32), sel


def select_decision_samples_interp(s_flat: torch.Tensor, w: torch.Tensor,
                                   sps: int):
    """Fractional-timing refined decision (feed-forward early-late).

    Circular first-harmonic (centroid) estimate of the intra-symbol energy
    profile: p = atan2(sum_j W[j] sin a_j, sum_j W[j] cos a_j) * sps / 2pi
    with a_j = 2pi j / sps, moved into [-0.5, sps - 0.5); the index used is
    round(p) % sps, and the decision is interpolated linearly between the
    two nearest samples in time, crossing symbol rows through the flat
    signal.  Row 0 with a negative offset would reach one sample before the
    flat buffer; it takes the on-sample decision (frac 0) instead.

    Args:
      s_flat: (..., R*sps) flattened time-contiguous samples; window row o
        starts at flat index o*sps.
      w: (..., S, sps) windowed bin sums.
    Returns (sample_index (..., S) int32, decision (..., S) complex64).
    """
    ang = (2.0 * math.pi) * torch.arange(sps, dtype=torch.float32,
                                         device=w.device) / sps
    zr = torch.sum(w * torch.cos(ang), dim=-1)
    zi = torch.sum(w * torch.sin(ang), dim=-1)
    p = torch.atan2(zi, zr) * (sps / (2.0 * math.pi))
    p = torch.where(p < -0.5, p + sps, p)
    p = torch.where(p > sps - 0.5, p - sps, p)
    b = torch.remainder(
        torch.round(torch.nan_to_num(p, nan=0.0)).to(torch.int32), sps)
    i0 = torch.floor(p)
    frac = (p - i0).to(torch.float32)
    s = w.shape[-2]
    raw_base = (torch.arange(s, dtype=torch.int64, device=w.device) * sps
                + torch.nan_to_num(i0, nan=0.0).to(torch.int64))
    oob = raw_base < 0
    frac = torch.where(oob, torch.zeros_like(frac), frac)
    base = torch.clamp(raw_base, 0, s_flat.shape[-1] - 2)
    s0 = torch.gather(s_flat, -1, base)
    s1 = torch.gather(s_flat, -1, base + 1)
    sel = (s0 * (1.0 - frac) + s1 * frac).to(torch.complex64)
    return b.to(torch.int32), sel
