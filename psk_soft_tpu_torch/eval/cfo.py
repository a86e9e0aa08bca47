"""Carrier-frequency-offset (CFO) estimation: host numpy copy of
``psk_soft_tpu/eval/cfo.py:26-103`` (the JAX package cannot be imported
here).

The phase debug port's ramp is the carrier offset: the linear-fit tracker
follows ``M * theta_cfo`` per symbol, so

    cfo = slope_per_symbol / (M * 2*pi * sps * xdelta)

The end-of-block M*2pi re-wrap makes the sequence jump by multiples of
M*2pi, so the slope comes from first differences wrapped into
(-M*pi, +M*pi].  :func:`acquire_cfo` is the coarse acquisition from the
M-th-power spectrum that runs before the tracker can lock.
"""

from __future__ import annotations

import numpy as np

from ..config import DemodConfig

TWO_PI = 2.0 * np.pi


def cfo_from_phase(phase, m, sps: int, xdelta: float = 1.0,
                   symbol_axis: int = -1) -> np.ndarray:
    """Per-channel CFO in Hz (cycles/sample with xdelta 1.0) from a block
    of phase-port samples with the symbol axis at ``symbol_axis`` (engine
    packets are (C, S); kernel planes (S, C): pass symbol_axis=0).  ``m``
    is scalar or per channel."""
    ph = np.asarray(phase, np.float64)
    if ph.shape[symbol_axis] < 2:
        raise ValueError("need at least 2 symbols of phase to estimate CFO")
    m_arr = np.asarray(m, np.float64)
    d = np.diff(ph, axis=symbol_axis)
    # Undo M*2pi re-wraps (the tracker's step per symbol is << pi for any
    # lockable offset, so no 2pi ambiguity remains).
    modulus = m_arr * TWO_PI
    mod_b = (np.expand_dims(modulus, symbol_axis) if modulus.ndim
             else modulus)
    d = d - mod_b * np.round(d / mod_b)
    slope = d.mean(axis=symbol_axis)           # rad of M*theta per symbol
    return slope / (m_arr * TWO_PI * sps * xdelta)


def cfo_from_packet(pkt, cfg: DemodConfig, in_xdelta: float | None = None,
                    m=None) -> np.ndarray:
    """CFO in Hz from a PORT_PHASE packet: its SRI carries the symbol
    spacing (sps * input xdelta); ``in_xdelta`` overrides a placeholder
    SRI and ``m`` (per channel) overrides cfg.constellation_size."""
    sym_dt = in_xdelta * cfg.sps if in_xdelta is not None else pkt.sri.xdelta
    mm = cfg.constellation_size if m is None else np.asarray(m)
    return cfo_from_phase(pkt.data, mm, sps=1, xdelta=sym_dt)


def acquire_cfo(x, m, nfft: int | None = None, xdelta: float = 1.0
                ) -> np.ndarray:
    """Coarse per-channel CFO from the M-th-power spectrum: x**M removes
    the modulation and leaves a tone at M*cfo, located by the FFT peak.
    Resolution 1/(M*nfft) cycles/sample; unambiguous for |cfo| < 1/(2M).

    x: complex baseband, (C, T) or (T,) host array; m scalar or per
    channel.  Returns the CFO per channel, (C,) or a scalar for 1-D input.
    """
    arr = np.asarray(x)
    one = arr.ndim == 1
    x2 = arr[None, :] if one else arr
    m_arr = np.broadcast_to(np.asarray(m, np.float64), (x2.shape[0],))
    if nfft is None:
        nfft = 1 << int(np.ceil(np.log2(max(x2.shape[1], 2))))
    out = np.empty(x2.shape[0], np.float64)
    for mv in np.unique(m_arr):
        rows = m_arr == mv
        X = np.fft.fft(x2[rows] ** int(mv), n=nfft, axis=1)
        k = np.argmax(np.abs(X), axis=1)
        f = ((k / nfft + 0.5) % 1.0) - 0.5        # wrap to [-0.5, 0.5)
        out[rows] = f / mv / xdelta
    return out[0] if one else out
