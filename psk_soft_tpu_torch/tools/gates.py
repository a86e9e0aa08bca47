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
* :func:`compare_service` holds an engine's packets against another run's
  (the card against the CPU), and :class:`TieRecord` records the timing
  window sums that let it rule a differing sample pick a near tie.
* :func:`check_loopback` holds a bit-layer loopback's frames against the
  information bits planted, and :func:`check_fec_soak` two runs of a
  stream-FEC soak against each other.

The tolerances are the JAX package's own (``tests/test_full_kernel.py:
60-68``: soft 3e-3, phase 2e-3) and the near-tie bounds that
``chip_smoke.py`` found on the card.
"""

from __future__ import annotations

import dataclasses
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


def _window_sums(e: torch.Tensor, num_avg: int) -> np.ndarray:
    """(C, S + num_avg - 1, sps) float64 energies -> (C, S, sps) window
    sums on the host."""
    cs = torch.cat([torch.zeros_like(e[:, :1]), e.cumsum(1)], 1)
    return (cs[:, num_avg:] - cs[:, :-num_avg]).cpu().numpy()


class TieRecord:
    """Records the float64 timing window sums of every output a run emits,
    in order, (C, outputs, sps): a context manager around a run of the
    feed-forward steps (``models/blockpsk.demod_block_ff``, swapped before
    an engine binds it) and of B1 (``models/full``'s kernel module,
    swapped for a recording proxy as :class:`B1Gate` swaps it, and
    composing with it).  :meth:`taint` then rules each differing sample
    pick between two runs of the same input a near tie (both picks'
    window sums within NEAR_TIE_REL of the largest) or a fault, and marks
    the outputs whose tracker window (phase_avg + the trend) holds such a
    pick.  No matched filter (its sums would be of filtered samples)."""

    def __init__(self):
        self.sums, self.spans = [], []

    def __enter__(self):
        from ..models import blockpsk, full

        ff, inner = blockpsk.demod_block_ff, full.demod_kernel
        record = self

        def ff_step(cfg, state, x, assume_steady=False):
            if cfg.matched_filter != "none":
                raise ValueError("TieRecord takes no matched filter")
            st, out = ff(cfg, state, x, assume_steady=assume_steady)
            n, sps = x.shape[0], cfg.sps
            e = torch.cat([state.win_samples, torch.as_tensor(
                x, device=state.win_samples.device).reshape(n, -1, sps)],
                1).to(torch.complex128).abs() ** 2
            cols = out.valid.any(0)
            if not torch.equal(cols, out.valid.all(0)):
                raise ValueError("TieRecord needs one valid mask a block")
            record._add(_window_sums(e, cfg.num_avg)[:, cols.cpu().numpy()],
                        cfg.phase_avg)
            return st, out

        class Recorded:             # the kernel module, B1 recorded
            def demod_full_tm(_, win_re, win_im, x_re, x_im, planes, **kw):
                if kw.get("mf_taps"):
                    raise ValueError("TieRecord takes no matched filter")
                out = inner.demod_full_tm(win_re, win_im, x_re, x_im,
                                          planes, **kw)
                e = sum(torch.cat([w, x]).double() ** 2
                        for w, x in ((win_re, x_re), (win_im, x_im)))
                sps, rows = kw["sps"], out[0].shape[0] + kw["num_avg"] - 1
                e = e[:rows * sps].reshape(rows, sps, -1).permute(2, 0, 1)
                record._add(_window_sums(e, kw["num_avg"]), kw["phase_avg"])
                return out

            def __getattr__(_, name):
                return getattr(inner, name)

        self._restore = ((blockpsk, "demod_block_ff", ff),
                         (full, "demod_kernel", inner))
        blockpsk.demod_block_ff = ff_step
        full.demod_kernel = Recorded()
        return self

    def __exit__(self, *exc):
        for mod, name, value in self._restore:
            setattr(mod, name, value)

    def _add(self, w: np.ndarray, phase_avg: int) -> None:
        self.sums.append(w)
        self.spans.append(np.full(w.shape[1], phase_avg + UNWRAP_TREND_LEN))

    def taint(self, got_idx: np.ndarray, ref_idx: np.ndarray):
        """(C, N) bool of the outputs held loosely: those at or up to the
        tracker span after a sample pick that differs between two runs at
        a near tie.  Raises AssertionError where a pick differs at no near
        tie.  Returns (taint, differing picks, widest gap)."""
        w, span = np.concatenate(self.sums, 1), np.concatenate(self.spans)
        if w.shape[:2] != got_idx.shape:
            raise AssertionError(f"TieRecord: {w.shape[:2]} outputs "
                                 f"recorded, {got_idx.shape} compared")
        taint = np.zeros(got_idx.shape, bool)
        widest = 0.0
        for c, k in np.argwhere(got_idx != ref_idx):
            top = w[c, k].max()
            gap = max(top - w[c, k, got_idx[c, k]],
                      top - w[c, k, ref_idx[c, k]]) / top
            if not gap < NEAR_TIE_REL:
                raise AssertionError(
                    f"channel {c} output {k}: sample index "
                    f"{got_idx[c, k]} against {ref_idx[c, k]}, window-sum "
                    f"gap {gap} (near-tie bound {NEAR_TIE_REL})")
            widest = max(widest, gap)
            taint[c, k:k + span[k] + 1] = True
        return taint, int((got_idx != ref_idx).sum()), widest


def compare_service(gpu, cpu, what: str, rows=None, ties=None,
                    soft_tol: float = SOFT_TOL) -> dict:
    """Packet lists of an engine, one run against another of the same
    input (the card against the CPU; either package's packets): the same
    packets (None where None), ports, SRIs (as fields), timestamps, EOS and
    sriChanged flags; bits and sample index equal; soft within
    ``soft_tol`` and phase within PHASE_TOL over the finite values,
    with NaN and inf at the same places.  ``rows`` keeps the first rows of
    each ``gpu`` packet's (C, n) data, for a run of fewer channels.  With
    ``ties`` (the :class:`TieRecord` of a run of ``n_ch`` channels) a
    sample index may differ at a near tie, and the outputs it taints are
    held to their shapes alone.  Returns the largest errors (and, with
    ``ties``, the near ties found and the widest)."""
    from ..runtime.streams import PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX

    worst = {"soft": 0.0, "phase": 0.0}
    if len(gpu) != len(cpu):
        raise AssertionError(f"{what}: {len(gpu)} vs {len(cpu)} outputs")
    pairs = []
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if (a is None) != (b is None) or (a is not None
                                          and set(a) != set(b)):
            raise AssertionError(f"{what} #{i}: ports differ")
        pair = {}
        for port in a or {}:
            pa, pb = a[port], b[port]
            da, db = np.asarray(pa.data), np.asarray(pb.data)
            if rows is not None and da.ndim == 2:
                da = da[:rows]
            if ((pa.t, pa.eos, pa.sri_changed)
                    != (pb.t, pb.eos, pb.sri_changed)
                    or dataclasses.asdict(pa.sri)
                    != dataclasses.asdict(pb.sri)
                    or da.shape != db.shape or da.dtype != db.dtype):
                raise AssertionError(f"{what} #{i} {port}: metadata differs")
            pair[port] = (da, db)
        pairs.append(pair)
    taint = None
    if ties is not None:
        n_ch = ties.sums[0].shape[0] if ties.sums else 1
        idx = [np.concatenate([p[PORT_SAMPLE_INDEX][j].reshape(n_ch, -1)
                               for p in pairs if p], 1).astype(np.int64)
               for j in (0, 1)]
        taint, worst["near_ties"], worst["near_tie_widest"] = ties.taint(
            *idx)
    at = 0
    for i, pair in enumerate(pairs):
        held = None
        if taint is not None and pair:
            n_out = pair[PORT_SAMPLE_INDEX][0].size // taint.shape[0]
            held = ~taint[:, at:at + n_out]
            at += n_out
        for port, (da, db) in pair.items():
            if held is not None:            # (C, n, values an output)
                if not held.shape[1]:
                    continue
                da = da.reshape(held.shape + (-1,))[held]
                db = db.reshape(held.shape + (-1,))[held]
            if port in (PORT_BITS, PORT_SAMPLE_INDEX):
                if not np.array_equal(da, db):
                    raise AssertionError(f"{what} #{i} {port}: differs at "
                                         f"{int((da != db).sum())}")
                continue
            fa, fb = np.isfinite(da), np.isfinite(db)
            if not (np.array_equal(fa, fb) and np.array_equal(
                    np.isnan(da), np.isnan(db))
                    and np.array_equal(da[~fa & ~np.isnan(da)],
                                       db[~fb & ~np.isnan(db)])):
                raise AssertionError(f"{what} #{i} {port}: non-finite "
                                     f"values differ")
            if fa.any():
                key = "phase" if port == PORT_PHASE else "soft"
                worst[key] = max(worst[key], float(
                    np.abs(da[fa] - db[fa]).max()))
    if worst["soft"] > soft_tol or worst["phase"] > PHASE_TOL:
        raise AssertionError(f"{what}: errors {worst}")
    return worst


def check_loopback(label: str, frames, starts, infos: np.ndarray,
                   coded: bool, crc: bool) -> int:
    """A bit-layer loopback (conformance.bitlayer_stream through the frame
    stack): on every channel exactly one frame at each planted start,
    its information bits (the frame bits when uncoded) those planted
    there (``infos``: (C, starts, n_info)), the CRC green where there is
    one.  Returns the frame count."""
    n_ch = infos.shape[0]
    got = {}
    for f in frames:
        key = (f.channel, f.start)
        if key in got or f.start not in starts:
            raise AssertionError(f"{label}: frame {key} decoded twice or at "
                                 f"an unplanted start")
        got[key] = f
    if len(got) != n_ch * len(starts):
        raise AssertionError(f"{label}: {len(got)} frames of "
                             f"{n_ch * len(starts)}")
    for (c, s0), f in got.items():
        bits = f.info_bits if coded else f.bits
        if (crc and f.crc_ok is not True) or not np.array_equal(
                np.asarray(bits), infos[c, starts.index(s0)]):
            raise AssertionError(f"{label}: frame {(c, s0)} bits or CRC "
                                 f"wrong")
    return len(got)


def check_fec_soak(label: str, got, ref) -> int:
    """Two runs of a stream-FEC soak script (conformance.run_fec_soak):
    the same events, step counts after each and popped bits.  Returns the
    bits compared."""
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} vs {len(ref)} events")
    n = 0
    for i, ((ev, a, sa), (ev_r, b, sb)) in enumerate(zip(got, ref)):
        if ev != ev_r or sa != sb or (a is None) != (b is None):
            raise AssertionError(f"{label} #{i} {ev}: steps {sa} vs {sb}")
        if a is not None:
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"{label} #{i}: popped bits differ")
            n += a.size
    return n
