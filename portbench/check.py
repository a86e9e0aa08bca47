"""The comparison that decides ``correct``: what the timed path delivered,
held against the plain reference (``reference/``) on the same capture.

Both sides start from the same stream at sample 0, so output e of the
reference (the window ending at symbol e + num_avg - 1) meets the program's
output at the same symbol.  The capture is periodic, and each channel's
carrier turns a whole number of times over it, so a pool position's outputs
recur every pass, the phase by whole multiples of M*2pi.  The reference runs
over the pool and two blocks more once, and a position in the pool's first
block is read in the second pass, after every warm-up.

Near ties (the rule, not a tolerance): the energy bins of rectangular pulses
lie close together, and where two bins' float64 window sums lie within
``TIE_REL`` of the largest, float32 arithmetic may pick either.  A differing
pick there is a tie, not a mismatch; it moves that output's sample and,
through the phase fit, the next ``phase_avg - 1`` outputs of its channel,
which the value comparisons leave out.  A differing pick beyond ``TIE_REL``
is a mismatch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import psk

TIE_REL = 1e-4


def wrap(x, period: float):
    return (x + period / 2) % period - period / 2


def ref_index(pool, window_end: np.ndarray, num_avg: int) -> np.ndarray:
    """Reference output index of each window-end symbol of the stream."""
    p = (window_end - (num_avg - 1)) % pool.period
    return np.where(p < pool.block_symbols, p + pool.period, p)


def run_reference(pool, demod: psk.Demod, rows=None, dtype=torch.float64,
                  device="cpu") -> dict:
    """The reference over the pool and two blocks more, on the channels
    ``rows`` (all by default)."""
    sel = None if rows is None else torch.as_tensor(np.asarray(rows))

    def blocks():
        for b in range(pool.blocks + 2):
            re, im = pool.planes(b, torch.float64, device)
            if sel is not None:
                s = sel.to(re.device)
                re, im = re[s], im[s]
            yield re, im

    n = pool.channels if rows is None else len(rows)
    return psk.demod_stream(blocks(), demod, n, dtype, device)


def tie_mask(prog_sidx: np.ndarray, gap: np.ndarray, ref_sidx: np.ndarray):
    """(ties, mismatches, widest tie gap) of the program's picks against
    the reference's: (C, S) bool planes and a float."""
    g = np.take_along_axis(gap, prog_sidx[..., None].astype(np.int64),
                           -1)[..., 0]
    differ = prog_sidx != ref_sidx
    ties = differ & (g <= TIE_REL)
    widest = float(g[ties].max()) if ties.any() else 0.0
    return ties, differ & ~ties, widest


def compare_ports(kept: dict, ref: dict, pool, demod: psk.Demod,
                  soft_scale: float | None) -> tuple[dict, dict]:
    """Numbers compared on the kept blocks of the engine path, and
    information beside them.  ``kept`` maps a stream block index to its
    (soft, bits, phase, sampleIndex) host arrays and the block before's
    sampleIndex."""
    s, m, pa, na = pool.block_symbols, demod.constellation_size, \
        demod.phase_avg, demod.num_avg
    nb = int(math.log2(m))
    out = dict(index_mismatches=0, bit_mismatches=0,
               soft_gap=0.0, phase_gap=0.0)
    info = dict(blocks_compared=0, outputs_compared=0, ties=0,
                widest_tie_gap=0.0)
    for b, (soft, bits, phase, sidx, prev_sidx) in sorted(kept.items()):
        ends = np.arange((b - 1) * s, (b + 1) * s)
        e = ref_index(pool, ends, na)
        r_sidx = ref["sidx"][:, e].numpy()
        gap = ref["gap"][:, e].numpy()
        both = np.concatenate([prev_sidx, sidx], axis=1)
        ties, mism, widest = tie_mask(both, gap, r_sidx)
        # A tie taints its own output and the next pa - 1 of its channel.
        run = np.cumsum(ties, axis=1)
        shifted = np.concatenate([np.zeros((ties.shape[0], pa), run.dtype),
                                  run[:, :-pa]], axis=1)
        clean = (run - shifted == 0)[:, s:]
        cur = e[s:]
        r_soft = ref["soft"][:, cur].numpy()
        r_phase = ref["phase"][:, cur].numpy()
        r_code = ref["code"][:, cur].numpy()
        bits3 = bits.reshape(bits.shape[0], s, nb).astype(np.int64)
        code = (bits3 << np.arange(nb)).sum(-1)
        out["index_mismatches"] += int(mism[:, s:].sum())
        out["bit_mismatches"] += int((code != r_code)[clean].sum())
        if soft_scale is None:
            gap_soft = np.abs(soft - r_soft)
        else:
            # int8 soft: how far the program's step lies beyond rounding.
            q = np.round(np.stack([soft.real, soft.imag]) * soft_scale)
            want = np.stack([r_soft.real, r_soft.imag]) * soft_scale
            gap_soft = np.maximum(np.abs(q - want).max(0) - 0.5, 0.0)
        if clean.any():
            out["soft_gap"] = max(out["soft_gap"],
                                  float(gap_soft[clean].max()))
            dph = np.abs(wrap(phase.astype(np.float64) - r_phase,
                              2 * math.pi * m))
            out["phase_gap"] = max(out["phase_gap"], float(dph[clean].max()))
        info["blocks_compared"] += 1
        info["outputs_compared"] += int(clean.sum())
        info["ties"] += int(ties[:, s:].sum())
        info["widest_tie_gap"] = max(info["widest_tie_gap"], widest)
    return out, info


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number at or under its limit.  Returns (correct, {name:
    {"value", "limit"}})."""
    lines = {}
    ok = True
    for name, value in numbers.items():
        lim = limits[name]
        lines[name] = {"value": value, "limit": lim}
        ok &= value <= lim
    return bool(ok), lines

