"""Correctness gates shared by ``chip_smoke.py`` and ``tools/bench.py``:
each holds a path's outputs before anything of it is timed or reported,
and raises ``AssertionError`` when they are wrong.

* :class:`B1Gate` holds every launch of kernel B1 made inside it against
  the kernel's plain version (``demod_full_tm_ref``) on the same inputs.
* :func:`check_b5` holds one launch of kernel B5 against its plain version
  (``timing_frontend_tm_ref``).
* :func:`check_frames` holds decoded frames against the frames planted in
  a periodic stream (offset, CRC, information bits), and
  :func:`required_frames` names the planted frames a run must decode.
* :func:`check_chain_steady` holds one steady block of the one-program
  chain (``models/chain`` seam tail) against the frames planted in it.

The tolerances are the JAX package's own (``tests/test_full_kernel.py:
60-68``: soft 3e-3, phase 2e-3) and the near-tie bounds that
``chip_smoke.py`` found on the card.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops import timing
from ..ops.cuda import demod_kernel, frontend_kernel
from ..ops.phase import UNWRAP_TREND_LEN

PHASE_TOL, SOFT_TOL = 2e-3, 3e-3
NEAR_TIE_REL = 1e-5           # argmax picks: relative window-sum gap
INTERP_TIE = 1e-4             # timing_interp: window-sum change to a tie


class B1Gate:
    """A checking wrapper over kernel B1 (``demod_kernel.demod_full_tm`` as
    models/full calls it), installed as a context manager around a path's
    gated run only, never around a timed one: every launch is held against
    ``demod_full_tm_ref`` on the same window, planes and carry.  Bits
    equal; a differing sample index only where both picks' window sums (in
    float64) lie within NEAR_TIE_REL of the largest, as chip_smoke.py's
    phase 3 rules on noise; soft within SOFT_TOL (int8 soft: at most one
    quantization step, where the float value sits on a rounding boundary)
    and phase within PHASE_TOL at the outputs whose tracker window
    (phase_avg + the trend) holds no differing pick (the others are
    counted, with their largest errors).  On ``noise_channels`` (no signal
    in their mode) bits, soft and phase are counted, not held.  With
    ``tied_bits`` (streams at low SNR, where another sample is another
    value and can slip the tracker a whole 2*pi/M turn for the rest of the
    block) a differing pick taints its channel's outputs from there to the
    end of the block, and bits are held where soft and phase are and
    counted at the tainted outputs.  A path that runs without debug ports
    gets one more launch with them on (a checking launch: the counts are
    put back), held bit-equal to the path's own.  Launch counts stay the
    kernel's (the plain version does not count).  Under a matched filter
    the near-tie sums are of the filtered samples; under timing_interp (the
    index rounds a centroid) a differing index is a near tie where a change
    of INTERP_TIE of the window sums' total moves the centroid across a
    rounding edge (the centroid of a flat window is ill-conditioned).  The
    gate also covers the time-sharded factory (parallel/sharded_full calls
    B1 itself), whose edge shards' halos are zero padding (outputs whose
    windows touch it are counted, not held: ``_unpadded``), and holds
    concurrent shards' launches one at a time."""

    def __init__(self, label: str, noise_channels=(),
                 tied_bits: bool = False):
        self.label, self.dk = label, demod_kernel
        self.kernel = demod_kernel.demod_full_tm
        self.noise = sorted(noise_channels)
        self.tied_bits = tied_bits
        self.lock = threading.Lock()
        self.trend = UNWRAP_TREND_LEN
        self.stats = dict(launches_checked=0, outputs=0, index_differ=0,
                          near_tie_widest=0.0, soft_max_err=0.0,
                          phase_max_err=0.0, noise_bits_differ=0,
                          noise_index_differ=0)

    def __enter__(self):
        from ..models import full
        from ..parallel import sharded_full

        class Checked:              # the kernel module, B1 checked
            demod_full_tm = self._locked_check

            def __getattr__(_, name):
                return getattr(self.dk, name)

        self._callers = (full, sharded_full)
        for mod in self._callers:
            mod.demod_kernel = Checked()
        return self

    def __exit__(self, *exc):
        for mod in self._callers:
            mod.demod_kernel = self.dk

    def _locked_check(self, *planes, **kw):
        with self.lock:
            return self._check(*planes, **kw)

    @staticmethod
    def _unpadded(re, im, kw, s_n: int, span: int):
        """(S,) bool: the outputs whose timing window and tracker reach
        (``span`` outputs back) touch no padding, a symbol with a raw row
        that is exactly zero on every channel (a time shard's edge halo;
        no stream has such rows).  Padded outputs are counted, not held:
        their windows hold no signal (the ROADMAP's zero-window ties)."""
        sps, na = kw["sps"], kw["num_avg"]
        rows = [torch.cat(pair) for pair in (re, im)]
        zero = ((rows[0] == 0).all(1) & (rows[1] == 0).all(1)).int()
        zc = torch.cat([zero.new_zeros(1), zero.cumsum(0)])
        extra = len(kw["mf_taps"]) - 1 if kw.get("mf_taps") else 0
        t = torch.arange(s_n + na - 1, device=zero.device)
        hi = torch.clamp((t + 1) * sps + extra, max=zero.numel())
        pad = ((zc[hi] - zc[t * sps]) > 0).int()
        pc = torch.cat([pad.new_zeros(1), pad.cumsum(0)])
        o = torch.arange(s_n, device=zero.device)
        return (pc[o + na] - pc[torch.clamp(o - span, min=0)]) == 0

    def _check(self, win_re, win_im, x_re, x_im, planes, **kw):
        got = self.kernel(win_re, win_im, x_re, x_im, planes, **kw)
        path_out = got
        if not kw.get("debug_ports", True):
            kw = dict(kw, debug_ports=True)
            k = self.kernel
            counts = (k.launches, dict(k.mode_launches))
            got = k(win_re, win_im, x_re, x_im, planes, **kw)
            k.launches = counts[0]
            k.mode_launches.update(counts[1])
            for i in (0, 1, 3, 5):
                if not torch.equal(path_out[i], got[i]):
                    raise AssertionError(f"{self.label}: B1 with debug "
                                         f"ports differs from the path's "
                                         f"launch (output {i})")
        ref = self.dk.demod_full_tm_ref(win_re, win_im, x_re, x_im, planes,
                                        **kw)
        sps, na = kw["sps"], kw["num_avg"]
        s_n, n_ch = got[0].shape
        sig = torch.ones(n_ch, dtype=torch.bool, device=x_re.device)
        sig[self.noise] = False
        span = kw["phase_avg"] + self.trend
        held = self._unpadded((win_re, x_re), (win_im, x_im), kw,
                              s_n, span)
        hold = sig[None, :] & held[:, None]
        g_idx, r_idx = got[4].long(), ref[4].long()
        same = g_idx == r_idx
        if not self.tied_bits and not torch.equal(got[3][hold],
                                                  ref[3][hold]):
            raise AssertionError(f"{self.label}: B1 bits differ from the "
                                 f"plain version at "
                                 f"{int((got[3] != ref[3])[hold].sum())} "
                                 f"symbols of signal channels")
        # A differing pick moves the tracker's phase for the outputs whose
        # window (phase_avg + the trend) holds it: those are counted, and
        # soft and phase held on the rest.
        differ = ~same & held[:, None]
        cs = torch.cat([torch.zeros_like(differ[:1], dtype=torch.int32),
                        differ.int().cumsum(0)])
        low = torch.clamp(torch.arange(1, s_n + 1, device=cs.device) - span
                          - 1, min=0)
        tainted = (cs[1:] - (0 if self.tied_bits else cs[low])) > 0
        keep = ~tainted & hold
        st = self.stats
        i8 = kw.get("soft_i8_scale")
        soft_tol = SOFT_TOL if i8 is None else max(SOFT_TOL, 1.0 / i8)
        for k, (a, b) in (("soft_max_err", (got[0], ref[0])),
                          ("soft_max_err", (got[1], ref[1])),
                          ("phase_max_err", (got[2], ref[2]))):
            d = (a.float() - b.float()).abs()
            if i8 is not None and k == "soft_max_err":
                d = d / i8                      # int8 steps to soft units
            if bool(keep.any()):
                st[k] = max(st[k], float(d[keep].max()))
            moved = tainted & hold
            if bool(moved.any()):
                st[f"near_tie_{k}"] = max(st.get(f"near_tie_{k}", 0.0),
                                          float(d[moved].max()))
        st["near_tie_outputs"] = st.get("near_tie_outputs", 0) + int(
            (tainted & hold).sum())
        if self.tied_bits:
            bits_differ = got[3] != ref[3]
            if bool((bits_differ & keep).any()):
                raise AssertionError(
                    f"{self.label}: B1 bits differ from the plain version "
                    f"at {int((bits_differ & keep).sum())} outputs no "
                    f"differing pick moved")
            st["near_tie_bits_differ"] = st.get("near_tie_bits_differ", 0) \
                + int((bits_differ & tainted & hold).sum())
        if not bool(held.all()):
            st["padding_outputs"] = st.get("padding_outputs", 0) + int(
                (~held).sum()) * n_ch
            st["padding_index_differ"] = st.get("padding_index_differ", 0) \
                + int((~same & ~held[:, None]).sum())
        n_differ = int(differ.sum())
        if n_differ:
            # Exact window sums of the [window | block] energies (of the
            # filtered samples under a matched filter).
            raw = [torch.cat([w, x]) for w, x in ((win_re, x_re),
                                                   (win_im, x_im))]
            if kw.get("mf_taps"):
                raw = self.dk.matched_filter_tm_ref(
                    *raw, kw["mf_taps"], in_scale=kw.get("in_scale", 1.0))
            e = raw[0].double() ** 2 + raw[1].double() ** 2
            e = e[:(s_n + na - 1) * sps].reshape(s_n + na - 1, sps, n_ch)
            cs = torch.cat([torch.zeros_like(e[:1]), e.cumsum(0)])
            wsum = cs[na:] - cs[:-na]                       # (S, sps, C)
            if kw.get("timing_interp"):
                # The index is round(p) of the circular centroid p of the
                # window sums W; a tie is where moving W by a fraction
                # INTERP_TIE of its total moves p across a rounding edge:
                # (distance to the edge) * (2pi/sps) * |z| / sum(W) below
                # it (|z| the centroid's resultant, small where W is flat).
                ang = torch.arange(sps, dtype=torch.float64,
                                   device=e.device) * (2 * np.pi / sps)
                zr = (wsum * torch.cos(ang)[:, None]).sum(1)
                zi = (wsum * torch.sin(ang)[:, None]).sum(1)
                pos = torch.atan2(zi, zr) * (sps / (2 * np.pi))
                pos = torch.where(pos < -0.5, pos + sps, pos)
                total = wsum.sum(1)
                gap = ((pos - torch.floor(pos) - 0.5).abs() * (2 * np.pi / sps)
                       * torch.hypot(zr, zi)
                       / torch.where(total > 0, total, torch.ones_like(total)))
                widest = float(gap[differ].max())
                bound = INTERP_TIE
            else:
                top = wsum.max(dim=1).values
                gap_g = (top - wsum.gather(1, g_idx[:, None]).squeeze(1)
                         ) / top
                gap_r = (top - wsum.gather(1, r_idx[:, None]).squeeze(1)
                         ) / top
                widest = float(torch.maximum(gap_g, gap_r)[differ].max())
                bound = NEAR_TIE_REL
            st["near_tie_widest"] = max(st["near_tie_widest"], widest)
            if widest >= bound:
                raise AssertionError(
                    f"{self.label}: B1 picks another sample than its plain "
                    f"version at {n_differ} outputs, widest gap {widest} "
                    f"(near-tie bound {bound}): a B1 fault")
        st["launches_checked"] += 1
        st["outputs"] += s_n * n_ch
        st["index_differ"] += int((differ & hold).sum())
        st["noise_index_differ"] += int((differ & ~sig[None, :]).sum())
        st["noise_bits_differ"] += int((got[3] != ref[3])[:, ~sig].sum())
        if st["soft_max_err"] > soft_tol or st["phase_max_err"] > PHASE_TOL:
            raise AssertionError(f"{self.label}: B1 against its plain "
                                 f"version: {st}")
        return path_out



def check_b5(label: str, win_re, win_im, x_re, x_im, *, sps: int,
             num_avg: int) -> dict:
    """Kernel B5 (``timing_frontend_tm``) against its plain version on the
    same window and block: a differing sample index only where the top two
    window sums of the [window | block] energies (float32, cumsum-diff)
    lie within NEAR_TIE_REL of the larger, and the decision samples equal
    wherever the index is.  Returns the count of differing indices and the
    widest gap among them."""
    got = frontend_kernel.timing_frontend_tm(win_re, win_im, x_re, x_im,
                                             sps=sps, num_avg=num_avg)
    ref = frontend_kernel.timing_frontend_tm_ref(win_re, win_im, x_re, x_im,
                                                 sps=sps, num_avg=num_avg)
    s_n, n_ch = got[2].shape
    re, im = torch.cat([win_re, x_re]), torch.cat([win_im, x_im])
    e = (re * re + im * im)[:(s_n + num_avg - 1) * sps].reshape(
        s_n + num_avg - 1, sps, n_ch).permute(2, 0, 1)
    top2 = timing.windowed_bin_sums(e, num_avg).topk(2, dim=-1).values
    gap = ((top2[..., 0] - top2[..., 1]) / top2[..., 0]).T       # (S, C)
    differ = got[2] != ref[2]
    n_differ = int(differ.sum())
    widest = float(gap[differ].max()) if n_differ else 0.0
    same = ~differ
    if widest >= NEAR_TIE_REL or not (
            torch.equal(got[0][same], ref[0][same])
            and torch.equal(got[1][same], ref[1][same])):
        raise AssertionError(f"B5 {label}: {n_differ} indices differ, "
                             f"widest gap {widest} (near-tie bound "
                             f"{NEAR_TIE_REL}), or the samples differ")
    return dict(index_differ=n_differ, widest_gap=widest,
                near_tie_bound=NEAR_TIE_REL)


def required_frames(starts, channels: int, period: int, n_blocks: int,
                    frame_len: int, lag: int) -> set:
    """(channel, start) of every frame planted at ``starts`` (offsets in a
    stream that repeats every ``period`` symbols) after the first block
    whose symbols all have demod rows in ``n_blocks`` blocks, the last
    ``lag`` symbols having none (num_avg - 1: the timing window's look
    ahead)."""
    last = n_blocks * period - lag
    return {(c, b * period + s0) for b in range(1, n_blocks) for s0 in starts
            for c in range(channels) if b * period + s0 + frame_len <= last}


def check_frames(label: str, frames, starts, infos: np.ndarray,
                 period: int, required=()) -> int:
    """Every frame once, at a planted offset (``start % period`` in
    ``starts``), with the CRC green, not suspect, and its first
    ``infos.shape[-1]`` information bits those planted there (``infos``:
    (C, k, n_msg)); every (channel, start) of ``required`` present.
    Returns the frame count."""
    planted = {s0 % period: j for j, s0 in enumerate(starts)}
    n_msg = infos.shape[-1]
    keys = [(f.channel, f.start) for f in frames]
    if len(set(keys)) != len(keys):
        raise AssertionError(f"{label}: a frame was decoded twice")
    for f in frames:
        j = planted.get(f.start % period)
        if (j is None or f.crc_ok is not True or f.suspect
                or f.info_bits is None
                or not np.array_equal(f.info_bits[:n_msg],
                                      infos[f.channel, j])):
            raise AssertionError(f"{label}: frame {(f.channel, f.start)} "
                                 f"at offset {f.start % period}, CRC "
                                 f"{f.crc_ok}, or its info bits wrong")
    missed = set(required) - set(keys)
    if missed:
        raise AssertionError(f"{label}: {len(missed)} of {len(required)} "
                             f"planted frames missed")
    return len(frames)


def check_chain_steady(outs, infos: np.ndarray, rows, period: int) -> int:
    """One steady block of the seam chain (``models/chain.ChainOutputs``
    fields msg, found, pos, ok, count): on every channel exactly the k
    planted frames (``infos``: (C, k, n_msg)), each committed at its
    planted detection row (``rows``, modulo ``period``), CRC green, its
    message bits exact.  Returns the frames checked."""
    msg, found, pos, ok, count = (
        t.cpu().numpy() for t in (outs.msg, outs.found, outs.pos, outs.ok,
                                  outs.count))
    k_frames = infos.shape[1]
    if not found.all():
        raise AssertionError(f"chain: missed {int((~found).sum())} frames")
    if not (count == k_frames).all():
        raise AssertionError("chain: unexpected extra peaks")
    if not ok.all():
        raise AssertionError(f"chain: {int((~ok).sum())} CRC failures")
    pos_mod = np.mod(pos, period)
    # Commits come earliest-first; map each to its planted frame.
    order = {int(r): j for j, r in enumerate(rows)}
    for slot in range(k_frames):
        r = pos_mod[:, slot]
        if not (r == r[0]).all():
            raise AssertionError("chain: channels disagree on positions")
        j = order.get(int(r[0]))
        if j is None:
            raise AssertionError(f"chain: commit at unplanted row "
                                 f"{int(r[0])}")
        if not (msg[:, slot] == infos[:, j]).all():
            raise AssertionError("chain: info bits wrong")
    return int(found.size)
