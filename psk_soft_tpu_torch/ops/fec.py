"""Forward error correction: convolutional codes, max-log PSK LLRs and
Viterbi decoding (port of ``psk_soft_tpu/ops/fec.py:58-330, 561-670``).

Conventions (as in the JAX package):

- Polynomials are integers (octal literals read naturally: ``0o171``);
  bit (K-1) taps the current input bit u[t], bit 0 the oldest u[t-K+1].
- State s_t packs (u[t-1] .. u[t-K+1]) with u[t-1] as the high bit, so the
  transition is ``s' = (u << (K-2)) | (s >> 1)`` and the input bit that
  entered state s' is its high bit (used by the traceback).
- Soft values are "positive means bit 0" LLRs; hard bits b map to 1-2b.
- ``terminate=True`` appends/assumes K-1 zero flush bits, pinning the
  final state (frame mode); ``terminate=False`` ends on the best state.

:func:`viterbi_decode` dispatches on the device of its input: a CPU tensor
runs the plain decoder here (:func:`_viterbi`, the JAX package's scan as a
loop over steps); a CUDA tensor goes to the hand-written kernels
(``ops/cuda/viterbi_kernel.viterbi_decode_kernel``).  The streaming and
time-parallel decoders wait for ROADMAP A.7.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_MAX_K = 10          # 512 states


def _later(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP: A.7, the "
                      f"per-stage bit layer)")


@dataclasses.dataclass(frozen=True)
class ConvCode:
    """Rate 1/n convolutional code.

    Attributes:
      k: constraint length K (memory K-1).
      polys: n generator polynomials, MSB = current input bit.
      puncture: optional (period, n) 0/1 keep-mask applied to the
        interleaved output stream (rate becomes period / kept).
    """

    k: int = 7
    polys: tuple = (0o171, 0o133)
    puncture: tuple | None = None

    def __post_init__(self):
        if not (2 <= self.k <= _MAX_K):
            raise ValueError(f"constraint length must be in [2, {_MAX_K}]")
        if len(self.polys) < 2:
            raise ValueError("need at least 2 generator polynomials")
        for g in self.polys:
            if not (0 < g < (1 << self.k)):
                raise ValueError(f"polynomial {g:o} out of range for "
                                 f"K={self.k}")
        if self.puncture is not None:
            p = np.asarray(self.puncture)
            if p.ndim != 2 or p.shape[1] != len(self.polys):
                raise ValueError("puncture mask must be (period, n)")
            if not p[0].all():
                raise ValueError("puncture mask must keep the first column "
                                 "(decoder alignment)")
            if p.sum() <= p.shape[0]:
                raise ValueError("puncture mask keeps too few bits (rate > 1)")

    @property
    def n(self) -> int:
        return len(self.polys)

    @property
    def states(self) -> int:
        return 1 << (self.k - 1)

    @property
    def rate(self) -> float:
        if self.puncture is None:
            return 1.0 / self.n
        p = np.asarray(self.puncture)
        return p.shape[0] / float(p.sum())


# Presets: the K=7 NASA/Voyager code, the K=9 code, and the 4-state
# textbook code.
CODE_K7 = ConvCode(7, (0o171, 0o133))
CODE_K9 = ConvCode(9, (0o561, 0o753))
CODE_K3 = ConvCode(3, (0o7, 0o5))
# DVB-S puncturing of the K=7 code.
PUNCTURE_2_3 = ((1, 1), (1, 0))
PUNCTURE_3_4 = ((1, 1), (1, 0), (0, 1))


def _tap_planes(code: ConvCode) -> np.ndarray:
    """(n, K) int8 tap matrix; column i multiplies u[t-i]."""
    taps = np.zeros((code.n, code.k), np.int8)
    for j, g in enumerate(code.polys):
        for i in range(code.k):
            taps[j, i] = (g >> (code.k - 1 - i)) & 1
    return taps


def conv_encode(code: ConvCode, bits, terminate: bool = True) -> torch.Tensor:
    """Encode a (..., N) 0/1 bit plane (tensor or array) -> (..., (N[+K-1])
    * n) int8 code bits, interleaved [y_0[0], y_1[0], ..., y_0[1], ...];
    with ``terminate`` the K-1 zero flush bits are appended first.
    Puncturing (if configured) drops masked positions."""
    u = torch.as_tensor(bits).to(torch.int8)
    lead = u.shape[:-1]
    if terminate:
        u = torch.cat([u, torch.zeros(lead + (code.k - 1,), dtype=torch.int8,
                                      device=u.device)], dim=-1)
    t = u.shape[-1]
    taps = _tap_planes(code)
    uu = torch.cat([torch.zeros(lead + (code.k - 1,), dtype=torch.int8,
                                device=u.device), u], dim=-1)
    outs = []
    for j in range(code.n):
        acc = torch.zeros_like(u)
        for i in range(code.k):
            if taps[j, i]:
                acc = acc ^ uu[..., code.k - 1 - i:code.k - 1 - i + t]
        outs.append(acc)
    y = torch.stack(outs, dim=-1).reshape(lead + (t * code.n,))
    if code.puncture is not None:
        keep = np.asarray(code.puncture, bool).reshape(-1)
        idx = np.flatnonzero(np.resize(keep, t * code.n))
        y = y[..., torch.as_tensor(idx, device=y.device)]
    return y


def info_bits_for(code: ConvCode, code_bit_count: int,
                  terminate: bool = True) -> int:
    """Information bits carried by ``code_bit_count`` transmitted bits
    (validates divisibility against the punctured code and the room for
    the flush bits)."""
    if code.puncture is not None:
        p = np.asarray(code.puncture)
        keep = int(p.sum())
        if code_bit_count % keep:
            raise ValueError(
                f"{code_bit_count} code bits is not a multiple of the "
                f"puncture period's kept count {keep}")
        steps = (code_bit_count // keep) * p.shape[0]
    else:
        if code_bit_count % code.n:
            raise ValueError(f"{code_bit_count} code bits is not a "
                             f"multiple of n={code.n}")
        steps = code_bit_count // code.n
    if terminate and steps <= code.k - 1:
        raise ValueError(f"{steps} trellis steps cannot carry the "
                         f"K-1={code.k - 1} flush bits")
    return steps - (code.k - 1 if terminate else 0)


def hard_llrs(code_bits) -> torch.Tensor:
    """Hard 0/1 code bits -> +/-1 float32 soft values (positive = bit 0)."""
    b = torch.as_tensor(code_bits)
    return (1 - 2 * b.to(torch.int32)).to(torch.float32)


def depuncture(code: ConvCode, llrs) -> torch.Tensor:
    """Re-insert zero-LLR erasures at punctured positions: (..., L)
    punctured soft stream -> (..., T*n) float32 full-rate stream."""
    y = torch.as_tensor(llrs).to(torch.float32)
    if code.puncture is None:
        return y
    keep = np.asarray(code.puncture, bool).reshape(-1)
    length = y.shape[-1]
    period = keep.sum()
    if length % period:
        raise ValueError(f"punctured length {length} not a multiple of the "
                         f"kept-per-period count {period}")
    full = (length // period) * keep.size
    dst = np.flatnonzero(np.resize(keep, full))
    out = torch.zeros(y.shape[:-1] + (full,), dtype=torch.float32,
                      device=y.device)
    out[..., torch.as_tensor(dst, device=y.device)] = y
    return out


def _trellis(code: ConvCode):
    """Host-precomputed trellis planes (pred, exp_sign): pred (S, 2) int32,
    the two predecessors of each state (differing in the oldest register
    bit); exp_sign (S, 2, n) float32, the +/-1 expected code-bit signs on
    pred[s', p] -> s' (sign = 1 - 2*bit)."""
    k, s_count = code.k, code.states
    s_prime = np.arange(s_count, dtype=np.int64)
    u = s_prime >> (k - 2)                       # input bit entering s'
    pred0 = (s_prime << 1) & (s_count - 1)
    pred = np.stack([pred0, pred0 | 1], axis=1)  # (S, 2)
    exp = np.zeros((s_count, 2, code.n), np.float32)
    for p in range(2):
        reg = (u << (k - 1)) | pred[:, p]        # [u[t], .., u[t-K+1]]
        for j in range(code.n):
            g = code.polys[j]
            bits = np.zeros(s_count, np.int64)
            for i in range(k):
                if (g >> (k - 1 - i)) & 1:
                    bits ^= (reg >> (k - 1 - i)) & 1
            exp[:, p, j] = 1.0 - 2.0 * bits
    return pred.astype(np.int32), exp


def _viterbi(llrs: torch.Tensor, exp_sign: torch.Tensor, k: int,
             s_count: int, terminate: bool) -> torch.Tensor:
    """Plain decoder: (B, T, n) LLRs -> (B, T) int8 bits (flush bits
    included).  The JAX package's ``_viterbi`` scan as a loop over steps:
    butterfly ACS (states s' and s' + S/2 share the predecessor pair
    {2j, 2j+1}), strict ``>`` (a tie keeps predecessor 0), re-zero against
    state 0's metric; traceback from state 0 (terminate) or the first
    maximum."""
    b, t, _ = llrs.shape
    dev = llrs.device
    pm = torch.full((b, s_count), -1e9, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    decs = []
    for step in range(t):
        r = llrs[:, step]                                   # (B, n)
        bm = (r[:, None, None, :] * exp_sign[None]).sum(-1)  # (B, S, 2)
        pairs = pm.reshape(b, s_count // 2, 2)
        cand = torch.cat([pairs, pairs], dim=1) + bm
        dec = cand[..., 1] > cand[..., 0]
        new = torch.where(dec, cand[..., 1], cand[..., 0])
        pm = new - new[:, 0:1]
        decs.append(dec)
    s = (torch.zeros(b, dtype=torch.int64, device=dev) if terminate
         else torch.argmax(pm, dim=1))
    bits = torch.empty((b, t), dtype=torch.int8, device=dev)
    for step in range(t - 1, -1, -1):
        bits[:, step] = ((s >> (k - 2)) & 1).to(torch.int8)
        p = torch.gather(decs[step], 1, s[:, None])[:, 0]
        s = ((s << 1) & (s_count - 1)) | p.to(torch.int64)
    return bits


def viterbi_decode(code: ConvCode, llrs, terminate: bool = True):
    """Maximum-likelihood decode of (..., L) soft code bits -> (..., N)
    int8 bits, N = T - (K-1) if terminated.

    Puncturing is undone by :func:`depuncture`.  A CPU tensor (or a numpy
    array) runs the plain decoder; a CUDA tensor runs kernels B2 (or B3 +
    B4) through ``viterbi_decode_kernel``.  Bits are identical either way.
    """
    y = torch.as_tensor(llrs)
    if y.device.type == "cuda":
        from .cuda.viterbi_kernel import viterbi_decode_kernel
        return viterbi_decode_kernel(code, y, terminate=terminate)
    if y.device.type != "cpu":
        raise ValueError(f"unsupported device {y.device}")
    y = depuncture(code, y)
    length = y.shape[-1]
    if length % code.n:
        raise ValueError(f"LLR length {length} not a multiple of n={code.n}")
    t = length // code.n
    if terminate and t <= code.k - 1:
        raise ValueError(f"{t} trellis steps cannot carry K-1="
                         f"{code.k - 1} flush bits")
    lead = y.shape[:-1]
    _, exp_sign = _trellis(code)
    bits = _viterbi(y.reshape(-1, t, code.n), torch.as_tensor(exp_sign),
                    code.k, code.states, terminate)
    if terminate:
        bits = bits[:, :t - (code.k - 1)]
    return bits.reshape(lead + (bits.shape[-1],))


def make_viterbi_fn(code: ConvCode, terminate: bool = True):
    """fn(llrs) -> bits with the code closed over."""
    return functools.partial(viterbi_decode, code, terminate=terminate)


def viterbi_stream_init(*args, **kwargs):
    raise _later("the streaming Viterbi decoder (viterbi_stream_init)")


def viterbi_stream_step(*args, **kwargs):
    raise _later("the streaming Viterbi decoder (viterbi_stream_step)")


def viterbi_stream_flush(*args, **kwargs):
    raise _later("the streaming Viterbi decoder (viterbi_stream_flush)")


def viterbi_decode_parallel(*args, **kwargs):
    raise _later("the time-parallel Viterbi decoder "
                 "(viterbi_decode_parallel)")


def make_stream_soft_fn(*args, **kwargs):
    raise _later("the streaming soft FEC step (make_stream_soft_fn)")


# -- constellation LLRs -------------------------------------------------------

def psk_llrs(m: int, soft, scale: float | None = None,
             labeling: str = "scd") -> torch.Tensor:
    """Max-log per-bit LLRs for M-PSK soft decisions.

    Same constellation convention as the demod output (angle 2*pi*k/M,
    +pi/4 for QPSK) with the bit labeling of ``ops/slicers.bit_labels``
    ("scd" or "gray").  LLR_i = (d1_i - d0_i) * scale with d_b the squared
    distance to the nearest point whose bit i equals b; positive = bit 0.
    The default scale divides by the mean squared magnitude over the last
    axis.

    Args:
      m: constellation size (2..32 power of two).
      soft: (..., S) complex soft decisions (tensor or array).
      scale: optional LLR scale.
      labeling: "scd" (default) or "gray".

    Returns:
      (..., S, log2(m)) float32 LLR planes on the input's device.
    """
    from .framesync import psk_points
    from .slicers import bit_labels

    if m not in (2, 4, 8, 16, 32):
        raise ValueError(f"unsupported constellation size {m}")
    soft = torch.as_tensor(soft)
    dev = soft.device
    pts = psk_points(np.arange(m), m)
    labels = torch.as_tensor(bit_labels(m, labeling).astype(np.float32),
                             device=dev)                          # (M, nb)
    pts_re = torch.as_tensor(np.ascontiguousarray(pts.real, np.float32),
                             device=dev)
    pts_im = torch.as_tensor(np.ascontiguousarray(pts.imag, np.float32),
                             device=dev)
    dr = soft.real[..., None] - pts_re
    di = soft.imag[..., None] - pts_im
    d2 = dr * dr + di * di                                        # (..., S, M)
    big = 1e30
    outs = []
    for i in range(labels.shape[1]):
        d0 = torch.amin(d2 + big * labels[:, i], dim=-1)
        d1 = torch.amin(d2 + big * (1.0 - labels[:, i]), dim=-1)
        outs.append(d1 - d0)
    llr = torch.stack(outs, dim=-1)                           # (..., S, nb)
    if scale is None:
        p = torch.mean(soft.real * soft.real + soft.imag * soft.imag,
                       dim=-1, keepdim=True)
        llr = llr / torch.clamp(p[..., None], min=1e-12)
    else:
        llr = llr * scale                                # in float32
    return llr
