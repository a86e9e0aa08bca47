"""Coded BER and the chain-level FER (port of ``psk_soft_tpu/eval/coded.py``).

:func:`measure_coded_ber` measures the FEC layer alone: info bits ->
encode -> slicer-labeled M-PSK -> complex AWGN -> ``psk_llrs`` ->
``viterbi_decode`` -> count.  The channel is seeded host numpy; the LLRs
and the decode run on ``device``, so on a CUDA device every point is one
batched kernel-B2 launch (B3 + B4 past B2's trellis envelope).

Eb/N0 accounting: the AWGN is set by Es/N0 per symbol; with rate R and
log2(M) bits a symbol, Eb/N0 = Es/N0 - 10*log10(R * log2(M)).

``union_bound`` is the first-terms soft-decision union bound from the
code's distance spectrum (Pb <= sum_d c_d Q(sqrt(2 d R Eb/N0))), tabulated
for the K=7 (171,133) and K=3 (7,5) codes.  It holds for BPSK (independent
noise per code bit); under the reference's non-Gray QPSK quadrant labeling
measured curves sit 1-2 dB right of it, and ``labeling="gray"`` lands on
it.

:func:`measure_chain_fer` drives the whole chain (``models/chain``: kernel
B1, seam frame sync, LLRs, kernel B2, CRC) block by block against AWGN,
with an optional per-channel carrier offset inside the tracker's range or
beyond it through the acquisition leg.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import tx
from ..ops.fec import ConvCode, conv_encode, psk_llrs, viterbi_decode
from .ber import qfunc

# Distance spectra {d: total information-bit weight c_d} (first terms).
_SPECTRA = {
    (7, (0o171, 0o133)): {10: 36, 12: 211, 14: 1404, 16: 11633},
    (3, (0o7, 0o5)): {5: 1, 6: 4, 7: 12, 8: 32},
}


def union_bound(code: ConvCode, ebn0_db) -> np.ndarray:
    """First-terms soft-decision union bound on BER (unpunctured codes)."""
    if code.puncture is not None:
        raise ValueError("spectrum table covers the unpunctured codes")
    try:
        spec = _SPECTRA[(code.k, tuple(code.polys))]
    except KeyError:
        raise ValueError(f"no tabulated spectrum for K={code.k} "
                         f"{tuple(oct(g) for g in code.polys)}") from None
    ebn0 = 10 ** (np.asarray(ebn0_db, np.float64) / 10)
    r = code.rate
    out = np.zeros_like(np.atleast_1d(ebn0))
    for d, c in spec.items():
        out = out + c * qfunc(np.sqrt(2.0 * d * r * ebn0))
    return out.reshape(np.shape(ebn0_db))


@dataclasses.dataclass
class CodedBerPoint:
    esn0_db: float          # per transmitted symbol
    ebn0_db: float          # per information bit
    ber: float
    n_bits: int
    n_errors: int
    frame_errors: int
    n_frames: int


def measure_coded_ber(code: ConvCode, m: int, esn0_db: float,
                      num_bits: int = 200_000, frame_bits: int = 1000,
                      interleave_rows: int | None = None,
                      labeling: str = "scd",
                      seed: int = 0, device="cuda") -> CodedBerPoint:
    """One coded-BER point on the AWGN channel.

    Blocks of ``frame_bits`` info bits are terminated, encoded, mapped to
    the slicer-labeled constellation, passed through complex AWGN at the
    given per-symbol Es/N0, and decoded in one batched Viterbi call on
    ``device``.
    """
    rng = np.random.default_rng(seed)
    nb = int(np.log2(m))
    frames = max(1, num_bits // frame_bits)
    info = rng.integers(0, 2, (frames, frame_bits), np.int8)
    coded = conv_encode(code, info).numpy()              # (F, L)
    l_real = coded.shape[1]
    if interleave_rows is not None:
        from ..ops.interleave import interleave
        coded = interleave(coded, interleave_rows).numpy()
    if l_real % nb:                                      # pad to symbols
        coded = np.concatenate(
            [coded, np.zeros((frames, nb - l_real % nb), np.int8)], axis=1)
    syms = tx.symbols_to_iq(m, tx.bits_to_symbols(m, coded, labeling))
    esn0 = 10 ** (esn0_db / 10)
    sigma = np.sqrt(1.0 / (2.0 * esn0))                  # unit Es, complex
    noisy = (syms + sigma * (rng.standard_normal(syms.shape)
                             + 1j * rng.standard_normal(syms.shape))
             ).astype(np.complex64)
    llr = psk_llrs(m, torch.from_numpy(noisy).to(device), scale=2.0 * esn0,
                   labeling=labeling)
    # Strip the symbol-pad LLRs: the decoder expects the exact code stream.
    llr = llr.reshape(frames, -1)[:, :l_real]
    if interleave_rows is not None:
        from ..ops.interleave import deinterleave
        llr = deinterleave(llr, interleave_rows)
    dec = viterbi_decode(code, llr.contiguous()).cpu().numpy()
    errs = (dec != info).sum(axis=1)
    n_err = int(errs.sum())
    n_bits_meas = info.size
    rate = code.rate
    ebn0_db = esn0_db - 10.0 * np.log10(rate * nb)
    return CodedBerPoint(
        esn0_db=float(esn0_db), ebn0_db=float(ebn0_db),
        ber=n_err / n_bits_meas, n_bits=n_bits_meas, n_errors=n_err,
        frame_errors=int((errs > 0).sum()), n_frames=frames)


def coded_ber_sweep(code: ConvCode, m: int, esn0_dbs,
                    **kw) -> list[CodedBerPoint]:
    return [measure_coded_ber(code, m, e, **kw) for e in esn0_dbs]


class ChainFerPoint(NamedTuple):
    """One chain-level operating point (see :func:`measure_chain_fer`)."""

    esn0_db: float
    frames: int          # frames transmitted
    found: int           # frames detected (UW sync)
    crc_ok: int          # detected frames with CRC green
    msg_exact: int       # detected frames decoding to the exact message
    overflow: int = 0    # peaks beyond the fixed sync capacity (count > k)

    @property
    def fer(self) -> float:
        """Frame-error rate: anything short of an exact, CRC-green,
        detected frame counts as an error."""
        return 1.0 - self.msg_exact / max(self.frames, 1)


def measure_chain_fer(cfg, fmt, code: ConvCode, crc, esn0_db: float, *,
                      channels: int = 128, blocks: int = 3,
                      rows=(80, 300), cfo: float = 0.0,
                      front_cfo: float = 0.0, seed: int = 0,
                      device="cuda") -> ChainFerPoint:
    """Frame-error rate of the receive chain at a given Es/N0, on
    ``device``.

    Drives ``models/chain.make_chain_fn`` (seam mode: kernel B1 -> seam
    frame sync -> LLRs -> kernel B2 -> CRC) block by block against AWGN:
    acquisition, timing, phase tracking, UW detection and decode all
    inside the measured loop.  Es/N0 is at the decision sample (rect
    pulses).  Each block carries fresh message bits in frames at ``rows``
    of its demod output.

    ``cfo`` adds a per-channel carrier offset the tracker must absorb:
    channel c gets cfo * (0.25 + 0.75 * c / (C-1)) cycles/sample, phase-
    continuous across the warm-up and every measured block.

    ``front_cfo`` (exclusive with ``cfo``) applies that spread beyond the
    tracker's lock instead and measures the acquisition leg: a per-channel
    coarse CFO from the M-th-power spectrum of the first block
    (eval/cfo.acquire_cfo) feeds the front chain's NCO
    (``models/chain.make_front_chain_fn``).  Acquisition errors count as
    frame errors.
    """
    from ..models.blockpsk import demod_block_ff, ff_init
    from ..models.chain import (_need_after, chain_init, chain_msg_bits,
                                front_chain_init, make_chain_fn,
                                make_front_chain_fn)
    from ..models.full import full_from_ff
    from ..ops.mixer import derotate_host

    m = cfg.constellation_size
    rng = np.random.default_rng(seed)
    n_msg = chain_msg_bits(fmt, code, crc)
    a1 = cfg.num_avg - 1
    starts = [r - a1 for r in rows]
    if any(s < 0 for s in starts):
        raise ValueError("rows must be >= num_avg - 1")
    # Every frame must commit in its own block under the seam window
    # (commit_hi = s_total - need_after), so max(rows) + need_after <=
    # s_total; the 128-symbol rounding is the JAX package's and fixes the
    # signal (and so the counts) to the same realization.
    s_total = max(max(starts) + fmt.frame_len + a1 + 8,
                  max(rows) + _need_after(fmt))
    s_total = -(-s_total // 128) * 128
    n_samp = s_total * cfg.sps
    sigma = float(np.sqrt(10.0 ** (-esn0_db / 10.0) / 2.0))
    if cfo and front_cfo:
        raise ValueError("cfo (in-tracker) and front_cfo (beyond-lock "
                         "acquisition leg) are exclusive")
    f_max = front_cfo or cfo
    if channels > 1:
        f_c = f_max * (0.25 + 0.75 * np.arange(channels) / (channels - 1))
    else:
        f_c = np.full(1, f_max)
    phi = np.zeros(channels)          # carrier phase carried across blocks

    def apply_cfo(x):
        nonlocal phi
        if f_max:
            ramp = (2 * np.pi * f_c[:, None] * np.arange(n_samp)[None]
                    + phi[:, None])
            x = (x * np.exp(1j * ramp)).astype(np.complex64)
            phi = np.mod(phi + 2 * np.pi * f_c * n_samp, 2 * np.pi)
        return x

    def plane(a):
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(device)

    k = len(rows)
    if front_cfo:
        step = make_front_chain_fn(cfg, fmt, code, k, crc=crc)
    else:
        step = make_chain_fn(cfg, fmt, code, k, crc=crc)
    state = None
    frames = found = crc_ok = msg_exact = overflow = 0
    for blk in range(blocks):
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
        idx_row = tx.frame_stream(fmt, infos, starts, s_total, code=code,
                                  crc=crc, labeling="gray",
                                  seed=seed * 101 + blk)
        x = np.repeat(np.exp(1j * (2 * np.pi
                                   * np.tile(idx_row, (channels, 1)) / m
                                   + 0.3)),
                      cfg.sps, axis=1).astype(np.complex64)
        x = apply_cfo(x)
        x += (sigma * (rng.standard_normal(x.shape)
                       + 1j * rng.standard_normal(x.shape))
              ).astype(np.complex64)
        if state is None:
            st_ff = ff_init(cfg, channels, device)
            if front_cfo:
                # Acquisition at the operating SNR from the first block
                # alone; the tracker converges on the estimate-derotated
                # signal (what the front chain's NCO will produce).
                from .cfo import acquire_cfo
                freq_est = np.asarray(acquire_cfo(x, m), np.float32)
                st_ff, _ = demod_block_ff(cfg, st_ff, torch.from_numpy(
                    derotate_host(x, freq_est)).to(device))
                state = front_chain_init(fmt, channels,
                                         full_from_ff(cfg, st_ff),
                                         freq=freq_est)
            else:
                st_ff, _ = demod_block_ff(cfg, st_ff,
                                          torch.from_numpy(x).to(device))
                state = chain_init(fmt, channels, full_from_ff(cfg, st_ff))
        state, out = step(state, plane(x.real), plane(x.imag))
        f = out.found.cpu().numpy()
        ok = out.ok.cpu().numpy() & f
        want = np.stack(infos)[None]                  # (1, k, n_msg)
        exact = ok & (out.msg.cpu().numpy() == want).all(axis=-1)
        frames += channels * k
        found += int(f.sum())
        crc_ok += int(ok.sum())
        msg_exact += int(exact.sum())
        overflow += int(np.maximum(out.count.cpu().numpy() - k, 0).sum())
    return ChainFerPoint(esn0_db, frames, found, crc_ok, msg_exact,
                         overflow)
