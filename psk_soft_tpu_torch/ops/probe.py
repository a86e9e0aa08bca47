"""Blind signal survey: symbol-rate estimation + PSK order classification
(port of ``psk_soft_tpu/ops/probe.py:44-213``).

psk_soft must be *configured* with the samples-per-baud and constellation
size (psk_soft.prf.xml:23-48).  This module estimates both, plus the coarse
CFO, directly from a captured bank, so a deployment can auto-configure.

Both estimators are classical cyclostationary detectors: the heavy work is
one batched FFT per bank on the device; only the (C, F) magnitudes come to
the host for the data-dependent peak logic (numpy, as in the JAX package).

- **Symbol rate**: the transition-energy sequence d[n] = |x[n+1]-x[n]|^2
  is periodic at the baud, so its spectrum carries a line at 1/sps.  The
  host picks the peak in the configured sps band, prefers a sub-harmonic
  when the fundamental is comparably strong, and refines to sub-bin
  accuracy with a 3-point parabolic fit.
- **PSK order + coarse CFO**: unit phasors u = x/|x| raised to the M-th
  power collapse M-PSK modulation to a tone at M*cfo
  (cpp/psk_soft.cpp:474's trick): the *smallest* M whose spectrum shows a
  dominant line is the constellation order, and the line's (parabolically
  refined) frequency / M is the CFO.  u^{2M} = (u^M)^2 chains the
  squarings.
"""

from __future__ import annotations

import numpy as np
import torch

_CANDIDATE_M = (2, 4, 8, 16, 32)


def _baud_spectrum(re: torch.Tensor, im: torch.Tensor,
                   nfft: int) -> torch.Tensor:
    """(C, T) planes -> (C, nfft//2+1) transition-energy magnitudes."""
    dr = re[:, 1:] - re[:, :-1]
    di = im[:, 1:] - im[:, :-1]
    d = dr * dr + di * di
    d = d - d.mean(dim=1, keepdim=True)
    return torch.fft.rfft(d, n=nfft, dim=1).abs()


def _power_spectra(re: torch.Tensor, im: torch.Tensor, n_m: int,
                   nfft: int) -> torch.Tensor:
    """(C, T) planes -> (C, n_m, nfft) |FFT(u^{2^(k+1)})| for k < n_m.

    u = x/|x| (envelope removed); repeated squaring chains the powers
    2, 4, 8, ... so candidate M are powers of two.
    """
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-30))
    ur, ui = re / mag, im / mag
    outs = []
    for _ in range(n_m):
        ur, ui = ur * ur - ui * ui, 2.0 * ur * ui      # u <- u^2
        z = torch.complex(ur, ui)
        outs.append(torch.fft.fft(z, n=nfft, dim=1).abs())
    return torch.stack(outs, dim=1)


def _parabolic(mag_row: np.ndarray, k: int) -> float:
    """3-point parabolic peak interpolation; returns the sub-bin offset."""
    if not (0 < k < mag_row.size - 1):
        return 0.0
    a, b, c = float(mag_row[k - 1]), float(mag_row[k]), float(mag_row[k + 1])
    den = a - 2.0 * b + c
    return 0.0 if den == 0.0 else float(np.clip(0.5 * (a - c) / den,
                                                -0.5, 0.5))


def _planes(x, device):
    """(re, im) float32 (C, T) planes of a complex input: a numpy array is
    uploaded to ``device``, a tensor stays on its own device."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(x, np.complex64)).to(device)
    if not t.is_complex():
        t = t.to(torch.complex64)
    return t.real.to(torch.float32), t.imag.to(torch.float32)


def estimate_baud(x, sps_min: float = 2.0, sps_max: float = 64.0,
                  nfft: int | None = None, *, device="cuda"):
    """Per-channel symbol-rate estimate from the transition-energy line.

    Args:
      x: (C, T) or (T,) complex baseband (numpy array, uploaded to
        ``device``, or a tensor on its own device).
      sps_min / sps_max: the plausible samples-per-symbol band.
      nfft: FFT length (default: next power of two >= T-1; more = finer
        raw bins, the parabolic fit refines either way).

    Returns:
      (sps, confidence): per-channel float arrays (scalars for 1-D
      input).  ``confidence`` is the line-to-median ratio inside the
      search band -- < ~5 means "no usable baud line".
    """
    one = x.ndim == 1
    if one:
        x = x[None]
    t = x.shape[-1]
    if t < 8:
        raise ValueError("need at least 8 samples")
    if not (1.0 < sps_min < sps_max):
        raise ValueError("need 1 < sps_min < sps_max")
    if nfft is None:
        nfft = 1 << int(np.ceil(np.log2(max(t - 1, 2))))
    mags = _baud_spectrum(*_planes(x, device), nfft).cpu().numpy()
    k_lo = max(int(np.floor(nfft / sps_max)), 1)
    k_hi = min(int(np.ceil(nfft / sps_min)), mags.shape[1] - 2)
    if k_hi <= k_lo:
        raise ValueError("sps band resolves to an empty FFT bin range; "
                         "capture more samples or widen the band")
    sps = np.zeros(mags.shape[0], np.float64)
    conf = np.zeros(mags.shape[0], np.float64)
    for c in range(mags.shape[0]):
        band = mags[c, k_lo:k_hi + 1]
        k = k_lo + int(np.argmax(band))
        peak = mags[c, k]
        # Prefer a strong sub-harmonic: narrow transition spikes spread
        # energy across harmonics and bin k may be a multiple of the
        # true line.
        for div in (2, 3):
            ks = int(round(k / div))
            if ks >= k_lo and mags[c, max(ks - 1, 0):ks + 2].max() \
                    >= 0.5 * peak:
                k = ks - 1 + int(np.argmax(mags[c, max(ks - 1, 0):ks + 2]))
                break
        f = (k + _parabolic(mags[c], k)) / nfft
        sps[c] = 1.0 / f if f > 0 else np.inf
        med = float(np.median(band))
        conf[c] = float(mags[c, k]) / max(med, 1e-30)
    if one:
        return float(sps[0]), float(conf[0])
    return sps, conf


def classify_psk(x, max_m: int = 8, nfft: int | None = None,
                 line_snr: float = 8.0, *, device="cuda"):
    """Blind PSK order + coarse CFO from the M-th-power line.

    Args:
      x: (C, T) or (T,) complex baseband (numpy array, uploaded to
        ``device``, or a tensor on its own device).
      max_m: largest candidate order (power of two <= 32).
      line_snr: peak-to-neighbourhood ratio a spectrum must show to count
        as a line (a false-alarm knob).

    Returns:
      (m, cfo, conf) per channel (scalars for 1-D input): the smallest
      power-of-two order whose spectrum shows a dominant line (0 when
      none does), the CFO in cycles/sample (parabolically refined), and
      that line's peak-to-neighbourhood ratio.
    """
    if max_m not in _CANDIDATE_M:
        raise ValueError(f"max_m must be one of {_CANDIDATE_M}")
    one = x.ndim == 1
    if one:
        x = x[None]
    t = x.shape[-1]
    if t < 8:
        raise ValueError("need at least 8 samples")
    n_m = _CANDIDATE_M.index(max_m) + 1
    if nfft is None:
        nfft = 1 << int(np.ceil(np.log2(max(t, 2))))
    mags = _power_spectra(*_planes(x, device), n_m,
                          nfft).cpu().numpy()                    # (C, nM, F)
    c_count = mags.shape[0]
    m_out = np.zeros(c_count, np.int32)
    cfo = np.zeros(c_count, np.float64)
    conf = np.zeros(c_count, np.float64)

    def line_ratio(row, k):
        # A spectral LINE is a single-bin spike: compare the peak to its
        # local neighbourhood (excluding +/-2 bins, wrap-around window).
        # A merely *colored* spectrum has comparable neighbours and fails
        # this test even though it beats the whole-band median.
        half = 32
        idx = (k + np.arange(-half, half + 1)) % row.size
        w = row[idx]
        keep = np.abs(np.arange(-half, half + 1)) > 2
        return float(row[k]) / max(float(np.mean(w[keep])), 1e-30)

    for c in range(c_count):
        for mi in range(n_m):
            m = _CANDIDATE_M[mi]
            row = mags[c, mi]
            k = int(np.argmax(row))
            ratio = line_ratio(row, k)
            if ratio >= line_snr:
                kf = k + _parabolic(row, k) if 0 < k < nfft - 1 else float(k)
                f = ((kf / nfft + 0.5) % 1.0) - 0.5
                m_out[c], cfo[c], conf[c] = m, f / m, ratio
                break
    if one:
        return int(m_out[0]), float(cfo[0]), float(conf[0])
    return m_out, cfo, conf
