"""Test-signal generators (numpy copy of ``psk_soft_tpu/testing/signals.py``).

``gen_psk`` reproduces the reference test fixture ``genPsk``
(``tests/test_psk_soft.py:98-117``) *bit-exactly*, including its Python 2
RNG semantics: the reference harness runs under Python 2 where
``random.choice(seq)`` is ``seq[int(random.random() * len(seq))]``; Python 3
changed ``choice`` to use ``_randbelow``, so we inline the Python 2 form to
draw the identical symbol sequence for ``random.seed(100)``
(``tests/test_psk_soft.py:41``).  The noise term is the reference's
``+ .0001 * random.random()`` -- a *real-valued positive* perturbation added
to the complex sample (tests/test_psk_soft.py:116).
"""

from __future__ import annotations

import cmath
import math
import random

import numpy as np


def gen_psk(num_symbols: int, samp_per_baud: int = 8, num_syms: int = 4,
            differential: bool = False, seed: int = 100,
            noise_amp: float = 1e-4):
    """Rectangular-pulse PSK baseband, matching tests/test_psk_soft.py:98-117.

    Returns:
      (samples complex64 ndarray of length num_symbols*samp_per_baud,
       symbols complex64 ndarray of the num_symbols transmitted points).
    """
    rng = random.Random()
    rng.seed(seed)
    cx = [cmath.exp(2j * math.pi * k / num_syms) for k in range(num_syms)]
    out = np.empty(num_symbols * samp_per_baud, np.complex64)
    syms = np.empty(num_symbols, np.complex64)
    last = 1.0 + 0.0j
    pos = 0
    for i in range(num_symbols):
        # Python 2 random.choice:
        x_cx = cx[int(rng.random() * num_syms)]
        syms[i] = x_cx
        if differential:
            val = x_cx * last
            last = val
        else:
            val = x_cx
        for _ in range(samp_per_baud):
            out[pos] = val + noise_amp * rng.random()
            pos += 1
    return out, syms


def gen_psk_channel(num_symbols: int, sps: int = 8, m: int = 4,
                    differential: bool = False, seed: int = 0,
                    freq_offset: float = 0.0, phase_offset: float = 0.0,
                    timing_offset: int = 0, snr_db: float | None = None,
                    pulse: str = "rect", rrc_beta: float = 0.35,
                    rrc_span: int = 8):
    """Richer generator for the capabilities the reference never tests
    (SURVEY.md section 4 implications): frequency offset, timing offset,
    real AWGN, RRC pulse shaping.

    Returns (samples complex64, symbol indices int32 ndarray).
    """
    rng = np.random.default_rng(seed)
    sym_idx = rng.integers(0, m, size=num_symbols).astype(np.int32)
    points = np.exp(2j * np.pi * sym_idx / m)
    if differential:
        points = np.cumprod(points)
    if pulse == "rect":
        x = np.repeat(points, sps)
    elif pulse == "rrc":
        from ..ops.matched_filter import rrc_taps
        taps = rrc_taps(sps, rrc_beta, rrc_span)
        up = np.zeros(num_symbols * sps, np.complex128)
        up[::sps] = points
        x = np.convolve(up, taps, mode="same")
    else:
        raise ValueError(f"unknown pulse {pulse!r}")
    if timing_offset:
        x = np.roll(x, timing_offset)
    t = np.arange(x.size)
    if freq_offset or phase_offset:
        x = x * np.exp(1j * (2 * np.pi * freq_offset * t + phase_offset))
    if snr_db is not None:
        # Es/N0 per sample relative to unit-power constellation.
        sigma = 10 ** (-snr_db / 20.0) / np.sqrt(2.0)
        x = x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return x.astype(np.complex64), sym_idx


def sinc_interp(x: np.ndarray, t, half: int = 48) -> np.ndarray:
    """Truncated-sinc band-limited interpolation of ``x`` at (fractional)
    sample positions ``t`` -- the test-fixture oracle for resampling
    (ops/resample.py): O(len(t) * 2*half) host numpy, edge-clamped.

    Positions within ``half`` samples of either end lose sinc terms and
    degrade; fixtures skip those spans when asserting tolerances.
    """
    t = np.asarray(t, np.float64)
    out = np.zeros(t.shape, np.complex128)
    for i, ti in enumerate(t):
        m0 = int(np.floor(ti)) - half
        m = np.arange(m0, m0 + 2 * half)
        m = m[(m >= 0) & (m < x.size)]
        out[i] = np.dot(x[m], np.sinc(ti - m))
    return out
