"""Plain reference of the REDHAWK ``psk_soft`` demodulator, written from its
published algorithm (``cpp/psk_soft.cpp``: per-sample energy bins over a
``numAvg``-symbol window, first-max argmax, the decision sample taken at the
window's oldest symbol, ``arg(sample^M)``, unwrap against the previous
estimate, a least-squares line over the last ``phaseAvg`` unwrapped phases
evaluated at the newest, ``-estimate/M`` derotation, ``+pi/4`` for QPSK, an
``M*2pi`` re-wrap of the history at the end of each block).

Vectorised over channels, sequential over symbols where the recursion is.
Complex values are kept as (re, im) pairs of real tensors so that the same
code runs in float64 (the reference) and in bfloat16 (the control).  It
imports neither the program under test nor JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TWO_PI = 2.0 * math.pi


class Demod(NamedTuple):
    """Widths of one deployment's demodulator (the configuration's
    ``demod`` group)."""

    sps: int
    num_avg: int
    constellation_size: int
    phase_avg: int
    differential: bool = False

    @classmethod
    def from_config(cls, demod: dict) -> "Demod":
        return cls(int(demod["sps"]), int(demod["num_avg"]),
                   int(demod["constellation_size"]), int(demod["phase_avg"]),
                   bool(demod.get("differential", False)))


def fit_weights(points: int, dtype, device) -> torch.Tensor:
    """(points,) weights w with sum(w * y) the least-squares line through
    y[0..points-1] (oldest first, unit spacing) evaluated at the newest
    point.  One point is its own fit."""
    x = torch.arange(points, dtype=torch.float64)
    if points == 1:
        w = torch.ones(1, dtype=torch.float64)
    else:
        xc = x - x.mean()
        w = 1.0 / points + xc * xc[-1] / (xc * xc).sum()
    return w.to(dtype=dtype, device=device)


def _mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def mth_power_angle(re: torch.Tensor, im: torch.Tensor, m: int):
    """arg(sample^M) for a power-of-two M, by repeated squaring."""
    k = m
    while k > 1:
        re, im = _mul(re, im, re, im)
        k >>= 1
    return torch.atan2(im, re)


def slice_code(m: int, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Packed LSB-first bit code of each soft decision, by the component's
    documented mapping (``psk_soft.scd.xml``): BPSK by the sign of I; QPSK
    by quadrant, (+,+) 00, (-,+) 01, (-,-) 10, (+,-) 11 as b0 + 2*b1; 8-PSK
    phase k*pi/4 to binary k."""
    if m == 2:
        return (re < 0).to(torch.int64)
    if m == 4:
        sr = (re < 0).to(torch.int64)
        si = (im < 0).to(torch.int64)
        return (sr ^ si) + 2 * si
    theta = torch.atan2(im.to(torch.float64), re.to(torch.float64))
    s = theta * (m / TWO_PI)
    s = torch.where(s < -0.5, s + m, s)
    return torch.floor(s + 0.5).to(torch.int64) & (m - 1)


class PskReference:
    """The recursion over a stream of channel-major blocks, lockstep across
    ``channels``.  :meth:`block` takes (C, T) re and im planes (T a whole
    number of symbols) and returns the outputs of every window that ends in
    the block, in emission order."""

    def __init__(self, demod: Demod, channels: int, dtype=torch.float64,
                 device="cpu"):
        if demod.constellation_size & (demod.constellation_size - 1):
            raise ValueError("constellation size must be a power of two")
        self.d = demod
        self.c = int(channels)
        self.dtype = dtype
        self.device = torch.device(device)
        self.tail_re = torch.zeros((self.c, 0), dtype=dtype,
                                   device=self.device)
        self.tail_im = self.tail_re.clone()
        self.est = torch.zeros(self.c, dtype=dtype, device=self.device)
        self.hist = torch.zeros((self.c, 0), dtype=dtype, device=self.device)
        self.last_re = torch.ones(self.c, dtype=dtype, device=self.device)
        self.last_im = torch.zeros(self.c, dtype=dtype, device=self.device)
        self.weights = [None] + [fit_weights(k, dtype, self.device)
                                 for k in range(1, demod.phase_avg + 1)]

    def block(self, re: torch.Tensor, im: torch.Tensor) -> dict:
        d, dt = self.d, self.dtype
        sps, na, m = d.sps, d.num_avg, d.constellation_size
        re = torch.cat([self.tail_re, re.to(self.device, dt)], dim=1)
        im = torch.cat([self.tail_im, im.to(self.device, dt)], dim=1)
        if re.shape[1] % sps:
            raise ValueError("blocks must hold whole symbols")
        keep = min(re.shape[1], (na - 1) * sps)
        self.tail_re, self.tail_im = re[:, re.shape[1] - keep:], \
            im[:, im.shape[1] - keep:]
        syms = re.shape[1] // sps
        outs = syms - (na - 1)
        if outs <= 0:
            return {}
        xr = re.reshape(self.c, syms, sps)
        xi = im.reshape(self.c, syms, sps)
        energy = xr * xr + xi * xi
        # Window sums of each sample offset over num_avg symbols, summed
        # one symbol at a time in the working precision.
        win = energy[:, 0:outs].clone()
        for k in range(1, na):
            win = win + energy[:, k:k + outs]
        sidx = torch.argmax(win, dim=-1)                       # first max
        top = win.max(dim=-1, keepdim=True).values
        gap = ((top - win) / top).to(torch.float32)
        pick = sidx.unsqueeze(-1)
        s_re = torch.gather(xr[:, :outs], 2, pick).squeeze(-1)
        s_im = torch.gather(xi[:, :outs], 2, pick).squeeze(-1)
        raw = mth_power_angle(s_re, s_im, m)
        phase = self._track(raw)
        if d.differential:
            prev_re = torch.cat([self.last_re[:, None], s_re[:, :-1]], 1)
            prev_im = torch.cat([self.last_im[:, None], s_im[:, :-1]], 1)
            den = prev_re * prev_re + prev_im * prev_im
            out_re, out_im = _mul(s_re, s_im, prev_re / den, -prev_im / den)
            corr = torch.zeros_like(phase)
            self.last_re, self.last_im = s_re[:, -1], s_im[:, -1]
        else:
            out_re, out_im = s_re, s_im
            corr = -phase / m
        if m == 4:
            corr = corr + math.pi / 4.0
        soft_re, soft_im = _mul(out_re, out_im, torch.cos(corr),
                                torch.sin(corr))
        # End of the block (the component's packet): re-wrap the estimator
        # history about M*2pi.
        wrap = TWO_PI * m
        off = torch.where(self.est.abs() > wrap,
                          torch.round(self.est / wrap) * wrap,
                          torch.zeros_like(self.est))
        self.est = self.est - off
        self.hist = self.hist - off[:, None]
        return dict(soft_re=soft_re, soft_im=soft_im, phase=phase,
                    sidx=sidx.to(torch.int8), gap=gap,
                    code=slice_code(m, soft_re, soft_im))

    def _track(self, raw: torch.Tensor) -> torch.Tensor:
        """Unwrap each raw phase against the running estimate, then refit:
        the sequential core.  Returns the estimate after each symbol."""
        pa = self.d.phase_avg
        h = self.hist.shape[1]
        n = raw.shape[1]
        work = torch.cat([self.hist, torch.zeros_like(raw)], dim=1)
        out = torch.empty_like(raw)
        est = self.est
        for i in range(n):
            r = raw[:, i]
            u = r + TWO_PI * torch.round((est - r) / TWO_PI)
            j = h + i
            work[:, j] = u
            lo = max(0, j - pa + 1)
            est = work[:, lo:j + 1] @ self.weights[j + 1 - lo]
            out[:, i] = est
        self.est = est
        self.hist = work[:, max(0, work.shape[1] - (pa - 1)):]
        return out


def demod_stream(blocks, demod: Demod, channels: int, dtype=torch.float64,
                 device="cpu") -> dict:
    """Run :class:`PskReference` over an iterable of (re, im) (C, T)
    blocks and concatenate the outputs on the CPU: ``soft`` complex
    (float64 parts), ``phase``, ``sidx`` (int8), ``code`` (int64) as (C, N)
    and ``gap`` (C, N, sps) float32, the relative gap of each energy bin
    below the largest.  Output e is the window ending at symbol e +
    num_avg - 1, whose decision sample lies in symbol e."""
    ref = PskReference(demod, channels, dtype, device)
    parts: dict = {}
    for re, im in blocks:
        o = ref.block(re, im)
        for k, v in o.items():
            parts.setdefault(k, []).append(v.cpu())
    cat = {k: torch.cat(v, dim=1) for k, v in parts.items()}
    soft = torch.complex(cat.pop("soft_re").to(torch.float64),
                         cat.pop("soft_im").to(torch.float64))
    return dict(soft=soft, phase=cat["phase"].to(torch.float64),
                sidx=cat["sidx"], code=cat["code"], gap=cat["gap"])
