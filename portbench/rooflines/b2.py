"""Kernel B2, Viterbi decoding of terminated frames: add-compare-select
over every state and trellis step of each row, then the traceback.

Operations: per (step, row, state) 4 * n + 3 (n branch-metric terms of two
candidates, two adds, a compare, a select).  Bytes: the LLRs (float32, n
a step) and the start metrics in, one byte a decoded bit out."""

from __future__ import annotations


def work(rows: int, steps: int, k: int = 7, n: int = 2) -> tuple[float,
                                                                 float]:
    """(operations, bytes) of one launch."""
    states = 1 << (k - 1)
    ops = steps * rows * states * (4 * n + 3)
    nbytes = n * steps * rows * 4 + states * rows * 4 + steps * rows
    return float(ops), float(nbytes)
