"""Forward error correction: convolutional codes, max-log PSK LLRs and
Viterbi decoding (port of ``psk_soft_tpu/ops/fec.py``).

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
(``ops/cuda/viterbi_kernel.viterbi_decode_kernel``).  The streaming decoder
(:func:`viterbi_stream_step`, :func:`viterbi_stream_flush`, port of
``psk_soft_tpu/ops/fec.py:331-431``) and the time-parallel one
(:func:`viterbi_decode_parallel`, ``:433-512``) dispatch the same way: a
CUDA tensor runs kernels B3 and B4 (B2 for the parallel windows that fit
it), a CPU tensor the plain loops here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

_MAX_K = 10          # 512 states


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


def _acs_scan(llrs: torch.Tensor, pm: torch.Tensor, exp_sign: torch.Tensor,
              s_count: int):
    """The ACS recursion of the JAX package's ``_make_acs`` over (B, T, n)
    LLRs from (B, S) metrics: butterfly ACS (states s' and s' + S/2 share
    the predecessor pair {2j, 2j+1}), strict ``>`` (a tie keeps
    predecessor 0), re-zero against state 0's metric.  Returns (final
    metrics, list of T (B, S) bool decisions)."""
    b = llrs.shape[0]
    decs = []
    for step in range(llrs.shape[1]):
        r = llrs[:, step]                                   # (B, n)
        bm = (r[:, None, None, :] * exp_sign[None]).sum(-1)  # (B, S, 2)
        pairs = pm.reshape(b, s_count // 2, 2)
        cand = torch.cat([pairs, pairs], dim=1) + bm
        dec = cand[..., 1] > cand[..., 0]
        new = torch.where(dec, cand[..., 1], cand[..., 0])
        pm = new - new[:, 0:1]
        decs.append(dec)
    return pm, decs


def _walk(decs, start: torch.Tensor, k: int, s_count: int) -> torch.Tensor:
    """Survivor walk (the JAX package's ``_make_back``) from (B,) start
    states back over decs[t] (B, S) -> (B, T) int8 bits."""
    s = start.to(torch.int64)
    bits = torch.empty((s.shape[0], len(decs)), dtype=torch.int8,
                       device=s.device)
    for step in range(len(decs) - 1, -1, -1):
        bits[:, step] = ((s >> (k - 2)) & 1).to(torch.int8)
        p = torch.gather(decs[step], 1, s[:, None])[:, 0]
        s = ((s << 1) & (s_count - 1)) | p.to(torch.int64)
    return bits


def _pinned(b: int, s_count: int, device) -> torch.Tensor:
    """(B, S) metrics pinned to state 0 (encoder reset)."""
    pm = torch.full((b, s_count), -1e9, dtype=torch.float32, device=device)
    pm[:, 0] = 0.0
    return pm


def _viterbi(llrs: torch.Tensor, exp_sign: torch.Tensor, k: int,
             s_count: int, terminate: bool) -> torch.Tensor:
    """Plain decoder: (B, T, n) LLRs -> (B, T) int8 bits (flush bits
    included).  The JAX package's ``_viterbi`` scan as a loop over steps
    (:func:`_acs_scan` from state 0); traceback from state 0 (terminate)
    or the first maximum."""
    b = llrs.shape[0]
    pm, decs = _acs_scan(llrs, _pinned(b, s_count, llrs.device), exp_sign,
                         s_count)
    start = (torch.zeros(b, dtype=torch.int64, device=llrs.device)
             if terminate else torch.argmax(pm, dim=1))
    return _walk(decs, start, k, s_count)


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


class ViterbiStreamState(NamedTuple):
    """Carry of the windowed streaming decoder, in the JAX package's
    layout, so checkpoints cross between the packages."""

    pm: torch.Tensor       # (B, S) float32 path metrics
    dec: torch.Tensor      # (D, B, S) bool decision window, oldest first


def viterbi_stream_init(code: ConvCode, batch: int, depth: int,
                        known_start: bool = True,
                        device="cuda") -> ViterbiStreamState:
    """Fresh streaming-decoder carry on ``device``.

    ``depth`` is the traceback window D in trellis steps (use >= 8-10
    constraint lengths; emitted bits lag the input by D steps and the
    first D emitted bits are pre-stream garbage the caller discards --
    runtime/fec.StreamFecDecoder handles both).  ``known_start`` pins the
    initial state to 0 (encoder reset); False starts uniform (mid-stream
    pickup, converges within the window).
    """
    if depth < code.k:
        raise ValueError(f"traceback depth {depth} below the constraint "
                         f"length {code.k}")
    s_count = code.states
    pm = (_pinned(batch, s_count, device) if known_start else
          torch.zeros((batch, s_count), dtype=torch.float32, device=device))
    return ViterbiStreamState(
        pm=pm, dec=torch.zeros((depth, batch, s_count), dtype=torch.bool,
                               device=device))


def _stream_block_kernels(code: ConvCode, state: ViterbiStreamState,
                          y: torch.Tensor):
    """The stream block on the kernels (the twin of the JAX package's
    ``_stream_block_planes``): B3 over the T new steps from the carried
    metrics, B4 over [history | new decisions] from the best state.  The
    kernels take any B, so no row padding."""
    from .cuda.viterbi_kernel import _signs_on, viterbi_acs, viterbi_traceback

    b, t, n = y.shape
    d = state.dec.shape[0]
    kw = dict(k=code.k, s_count=code.states)
    dec_new, pm2 = viterbi_acs(
        y.permute(2, 1, 0).contiguous(), state.pm.T.contiguous(),
        _signs_on(code, y.device), n=n, t_actual=t, **kw)   # (T, S, B)
    # A fresh (D+T, S, B) plane: torch.cat allocates it aligned.
    full = torch.cat([state.dec.permute(0, 2, 1).to(torch.int8), dec_new])
    start = torch.argmax(pm2, dim=0).to(torch.int32)[None]
    bits = viterbi_traceback(full, start, t_actual=d + t, **kw)
    return (ViterbiStreamState(
                pm=pm2.T.contiguous(),
                dec=full[t:].permute(0, 2, 1).to(torch.bool).contiguous()),
            bits[:t].T.contiguous())


def _stream_tail_kernel(code: ConvCode,
                        state: ViterbiStreamState) -> torch.Tensor:
    """The flush on B4: the (D, S, B) window walked from the best state."""
    from .cuda.viterbi_kernel import viterbi_traceback

    bits = viterbi_traceback(
        state.dec.permute(0, 2, 1).to(torch.int8).contiguous(),
        torch.argmax(state.pm, dim=1).to(torch.int32)[None], k=code.k,
        s_count=code.states, t_actual=state.dec.shape[0])
    return bits.T.contiguous()


def viterbi_stream_step(code: ConvCode, state: ViterbiStreamState, llrs):
    """Feed (B, T, n) soft steps; returns (state', (B, T) int8 delayed
    bits).

    Emitted bit t of this call decodes the trellis step D positions
    before it (D = window depth): the caller sees the stream shifted by
    D steps.  Puncturing: depuncture before calling (period-aligned
    blocks need no phase carry).  A CUDA tensor runs kernels B3 and B4, a
    CPU tensor the plain loops; the carry is the same either way.
    """
    y = torch.as_tensor(llrs).to(device=state.pm.device, dtype=torch.float32)
    if y.ndim != 3 or y.shape[-1] != code.n:
        raise ValueError(f"expected (B, T, {code.n}) LLR steps; "
                         f"got {tuple(y.shape)}")
    b, t, _ = y.shape
    if t == 0:
        return state, torch.zeros((b, 0), dtype=torch.int8, device=y.device)
    if y.device.type == "cuda":
        return _stream_block_kernels(code, state, y)
    if y.device.type != "cpu":
        raise ValueError(f"unsupported device {y.device}")
    _, exp_sign = _trellis(code)
    pm, decs = _acs_scan(y, state.pm, torch.as_tensor(exp_sign), code.states)
    full = list(state.dec.unbind(0)) + decs                 # D+T of (B, S)
    bits = _walk(full, torch.argmax(pm, dim=1), code.k, code.states)
    return ViterbiStreamState(pm=pm, dec=torch.stack(full[t:])), bits[:, :t]


def viterbi_stream_flush(code: ConvCode,
                         state: ViterbiStreamState) -> torch.Tensor:
    """End of stream: decode the (B, D) bits still inside the window,
    walked back from the best state (B4 on a CUDA carry)."""
    if state.pm.device.type == "cuda":
        return _stream_tail_kernel(code, state)
    return _walk(list(state.dec.unbind(0)), torch.argmax(state.pm, dim=1),
                 code.k, code.states)


def viterbi_decode_parallel(code: ConvCode, llrs, chunk: int = 512,
                            margin: int | None = None) -> torch.Tensor:
    """Time-parallel Viterbi: overlap-save over the trellis.

    The T steps split into P chunks; each gets a ``margin``-step lead-in
    (the metrics converge to the true survivors within the survivor-merge
    depth) and a ``margin``-step tail (the traceback from the chunk end
    converges back within the same depth), and every chunk decodes as a
    row of one batch of ``chunk + 2*margin``-step windows: B2 when the
    span fits it, else B3 + B4 (the plain decoder on a CPU tensor).  With
    margin >= ~10 constraint lengths the output equals the sequential
    decode.

    Args:
      llrs: (..., L) soft code bits (punctured ok), terminate=False
        semantics.
      chunk: steps decoded per parallel chunk.
      margin: two-sided overlap in steps (default 10 * K).

    Returns:
      (..., T) int8 decoded bits.
    """
    if margin is None:
        margin = 10 * code.k
    y = depuncture(code, torch.as_tensor(llrs).to(torch.float32))
    length = y.shape[-1]
    if length % code.n:
        raise ValueError(f"LLR length {length} not a multiple of "
                         f"n={code.n}")
    t = length // code.n
    lead = y.shape[:-1]
    steps = y.reshape(-1, t, code.n)
    b = steps.shape[0]
    if chunk < 1 or margin < code.k:
        raise ValueError("need chunk >= 1 and margin >= K")
    if t <= chunk + 2 * margin:
        return viterbi_decode(code, llrs, terminate=False)
    p = -(-t // chunk)                           # chunks
    span = chunk + 2 * margin
    # Window p covers steps [p*chunk - margin, p*chunk + chunk + margin).
    # Leading pad: strong bit-0 LLRs (the all-zero path reproduces the
    # encoder's zero start, the pin of the sequential decode); trailing
    # pad: zero LLRs (erasures).
    pad_hi = p * chunk + margin - t
    padded = torch.cat([
        torch.full((b, margin, code.n), 1e4, dtype=torch.float32,
                   device=y.device),
        steps,
        torch.zeros((b, pad_hi, code.n), dtype=torch.float32,
                    device=y.device)], dim=1)
    wins = padded.unfold(1, span, chunk)         # (B, P, n, span)
    wins = wins.permute(0, 1, 3, 2).reshape(b * p, span * code.n)
    # The windows are depunctured already: decode them with the
    # unpunctured code, every row pinned at state 0 (the margin lead-in
    # re-converges the rows past the head).
    bits = viterbi_decode(ConvCode(code.k, code.polys), wins,
                          terminate=False)       # (B*P, span)
    bits = bits.reshape(b, p, span)[:, :, margin:margin + chunk]
    bits = bits.reshape(b, p * chunk)[:, :t]
    return bits.reshape(lead + (t,))


def make_stream_soft_fn(code: ConvCode, m: int, labeling: str = "scd"):
    """fn(state, soft) -> (state', bits): the whole streaming-FEC block
    (constellation LLRs -> depuncture -> ACS -> windowed traceback) on
    the soft tensor's device.  ``soft`` (B, S_sym) must carry a whole
    number of puncture-period- and symbol-aligned trellis steps;
    runtime/fec.StreamFecDecoder does the chunk bookkeeping."""

    def step(state: ViterbiStreamState, soft):
        soft = torch.as_tensor(soft)
        llr = psk_llrs(m, soft, labeling=labeling)       # (B, S_sym, nb)
        full = depuncture(code, llr.reshape(soft.shape[0], -1))
        return viterbi_stream_step(
            code, state, full.reshape(soft.shape[0], -1, code.n))

    return step


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
