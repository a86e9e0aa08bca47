"""Engine observability and the feed-forward carry resync shared by the
engines (port of ``psk_soft_tpu/runtime/engine_stream.py:32-43`` and
``:288-344``).  The single-stream ``StreamEngine`` itself is ROADMAP A.5."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import state as state_mod
from ..config import DemodConfig
from ..models import blockpsk


@dataclasses.dataclass
class EngineMetrics:
    """Observability counters (symbols out, resyncs, ...)."""

    packets_in: int = 0
    samples_in: int = 0
    symbols_out: int = 0
    bits_out: int = 0
    resets: int = 0
    reconfigures: int = 0
    real_mode_drops: int = 0
    eos_seen: int = 0


def reconfigure_ff(old_cfg: DemodConfig, new_cfg: DemodConfig,
                   state: blockpsk.FFState) -> blockpsk.FFState:
    """C7 resync of the feed-forward carry (reference
    cpp/psk_soft.cpp:408-426, 619-651), on the carry's device:

    * sps / num_avg change: keep up to the new window's worth of the most
      recent samples, re-binned (:func:`state.resync_window`);
    * constellation change: the phase history is cleared;
    * phase_avg change: the history keeps its newest points.

    Host-side numpy (shapes change), once per property change."""
    dev = state.seen.device
    st = blockpsk.FFState(*(t.cpu().numpy() for t in state))
    channel_shape = np.shape(st.seen)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731,E501
    new = blockpsk.ff_init(new_cfg, channel_shape[0], dev)
    new = new._replace(last_any=to(st.last_any))
    mf_keys = ("matched_filter", "sps", "rrc_beta", "rrc_span")
    if all(getattr(old_cfg, k) == getattr(new_cfg, k) for k in mf_keys):
        new = new._replace(mf_tail=to(st.mf_tail))

    resync = state_mod.resync_window(old_cfg, new_cfg, st.win_samples,
                                     st.seen)
    if resync is None:
        new = new._replace(win_samples=to(st.win_samples),
                           win_energy=to(st.win_energy), seen=to(st.seen))
    else:
        ws, we, seen = resync
        new = new._replace(win_samples=to(ws), win_energy=to(we),
                           seen=to(seen))

    if old_cfg.constellation_size != new_cfg.constellation_size:
        return new  # phase history force-cleared (cpp/psk_soft.cpp:416-420)

    n_old, n_new = old_cfg.phase_avg, new_cfg.phase_avg
    hist = st.phase_hist                          # right-aligned (n_old-1,)
    # The history keeps at most n_old-1 live values (the n-th lives only in
    # the fit), so the carried count is capped by what survives.
    count = np.minimum(st.phase_count, max(n_old - 1, 1))
    keep = np.minimum(count, max(n_new - 1, 0))
    m = max(n_new - 1, 0)
    L = max(n_old - 1, 0)
    # Right-align the newest keep values: new[..., s] = hist[..., L-m+s]
    # masked to s >= m-keep.
    if m > 0 and L > 0:
        s = np.arange(m)
        idx = np.broadcast_to(np.clip(L - m + s, 0, L - 1),
                              channel_shape + (m,))
        gathered = np.take_along_axis(hist, idx, axis=-1)
        mask = s >= (m - keep[..., None])
        new_hist = np.where(mask, gathered, 0.0).astype(np.float32)
    else:
        new_hist = np.zeros(channel_shape + (m,), np.float32)
    return new._replace(
        phase_hist=to(new_hist),
        phase_count=to(np.minimum(count, n_new).astype(np.int32)),
        last_phase=to(st.last_phase),
    )
