"""Port parity, frame sync: psk_soft_tpu_torch's ops/framesync against the
JAX package on the CPU, fed the same numpy soft planes.

``sync_extract_topk_tm`` is written differently for the GPU (unfold
correlation, sliding maxima, a scatter of the earliest peaks, a gather of
the payloads), so it is held to the JAX function's results: found, pos and
count equal; ang and the derotated payloads within 1e-5 (float sums in
another order) where a frame was found.  Rows where ``found`` is False are
garbage by the SyncResult contract (the JAX function's ang there is the
angle of a sum of signed zeros).  Both JAX correlation branches are
covered (U < 8: shifted sums; U >= 8: the banded matmul).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu.ops import framesync as jfs
from psk_soft_tpu.ops import tx
from psk_soft_tpu_torch.ops import framesync as fs

torch.set_num_threads(1)

TOL = 1e-5


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_frame_types_match_jax():
    assert _fields(fs.FrameFormat) == _fields(jfs.FrameFormat)
    assert ([f.name for f in dataclasses.fields(fs.Frame)]
            == [f.name for f in dataclasses.fields(jfs.Frame)])
    assert fs.SyncResult._fields == jfs.SyncResult._fields
    for m in (2, 4, 8, 16):
        np.testing.assert_array_equal(fs.psk_points(np.arange(m), m),
                                      jfs.psk_points(np.arange(m), m))
    fmt = fs.FrameFormat(uw=(0, 1, 2, 3), payload=10, m=4, min_sep=7)
    assert (fmt.uw_len, fmt.frame_len, fmt.separation) == (4, 14, 7)
    np.testing.assert_array_equal(fmt.points, jfs.uw_points((0, 1, 2, 3), 4))
    for bad in (dict(uw=()), dict(uw=(0, 4)), dict(payload=-1),
                dict(threshold=0.0), dict(uw=(0,) * 257)):
        with pytest.raises(ValueError):
            fs.FrameFormat(**{**dict(uw=(0, 1), payload=4), **bad})


def _soft(fmt, starts, length, channels, seed, noise=0.05):
    """(C, length) complex64 soft stream with uncoded frames at starts."""
    rng = np.random.default_rng(seed)
    nb = int(np.log2(fmt.m))
    rows = []
    for c in range(channels):
        infos = [rng.integers(0, 2, fmt.payload * nb) for _ in starts]
        idx = tx.frame_stream(fmt, infos, starts, length, seed=seed + c)
        pts = jfs.psk_points(idx, fmt.m)
        rows.append(pts * np.exp(1j * np.pi / 2 * (c % 4)))  # M-fold rot
    soft = np.stack(rows)
    soft = soft + noise * (rng.standard_normal(soft.shape)
                           + 1j * rng.standard_normal(soft.shape))
    return soft.astype(np.complex64)


def _compare(soft, jfmt, k, **window):
    want = jfs.sync_extract_topk_tm(jnp.asarray(soft.real.T),
                                    jnp.asarray(soft.imag.T), jfmt, k,
                                    **window)
    fmt = fs.FrameFormat(**dataclasses.asdict(jfmt))
    got = fs.sync_extract_topk_tm(
        torch.from_numpy(np.ascontiguousarray(soft.real.T)),
        torch.from_numpy(np.ascontiguousarray(soft.imag.T)), fmt, k,
        **window)
    c = soft.shape[0]
    assert got.payloads.shape == (c, k, fmt.payload)
    assert got.payloads.dtype == torch.complex64
    assert got.pos.dtype == got.count.dtype == torch.int32
    for name in ("found", "pos", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    found = got.found.numpy()
    np.testing.assert_allclose(got.ang.numpy()[found],
                               np.asarray(want.ang)[found], atol=TOL, rtol=0)
    np.testing.assert_allclose(got.payloads.numpy()[found],
                               np.asarray(want.payloads)[found], atol=TOL,
                               rtol=0)
    return got


@pytest.mark.parametrize("window", [{}, dict(commit_lo=30, commit_hi=150),
                                    dict(commit_lo=0, commit_hi=0)])
@pytest.mark.parametrize("u_len", [6, 16, 32])
def test_sync_extract_topk_tm_matches_jax(u_len, window):
    rng = np.random.default_rng(u_len)
    fmt = jfs.FrameFormat(uw=tuple(rng.integers(0, 4, u_len)), payload=20,
                          m=4, threshold=0.7 if u_len > 8 else 0.9)
    starts = [3, 58, 113, 168]
    soft = _soft(fmt, starts, 230, channels=8, seed=u_len)
    got = _compare(soft, fmt, 3, **window)
    if u_len >= 16 and not window:
        # Every planted frame inside the default window, earliest 3 kept.
        assert (got.count.numpy() == 4).all() and got.found.all()
        np.testing.assert_array_equal(got.pos.numpy()[0], starts[:3])


def test_sync_over_capacity_and_short_separation():
    """More peaks than the capacity (count > k); and min_sep shorter than
    the frame, where the detection window outspans it."""
    rng = np.random.default_rng(7)
    fmt = jfs.FrameFormat(uw=tuple(rng.integers(0, 8, 24)), payload=12,
                          m=8, threshold=0.7, min_sep=20)
    starts = [0, 40, 80, 120, 160]
    soft = _soft(fmt, starts, 210, channels=4, seed=8)
    got = _compare(soft, fmt, 2)
    assert (got.count.numpy() == 5).all() and got.found.all()
    _compare(soft, fmt, 6)
    _compare(soft, fmt, 1, commit_lo=50, commit_hi=170)


def test_sync_wrapper_and_errors():
    rng = np.random.default_rng(9)
    jfmt = jfs.FrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=16,
                           m=4, threshold=0.7)
    fmt = fs.FrameFormat(**dataclasses.asdict(jfmt))
    soft = _soft(jfmt, [10, 90], 140, channels=3, seed=10)
    got = fs.sync_extract_topk(torch.from_numpy(soft), fmt, 2)
    want = jfs.sync_extract_topk(jnp.asarray(soft), jfmt, 2)
    assert got.found.all() and np.asarray(want.found).all()
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_allclose(got.payloads.numpy(),
                               np.asarray(want.payloads), atol=TOL, rtol=0)
    planes = torch.zeros((140, 3)), torch.zeros((140, 3))
    with pytest.raises(ValueError, match="commit_hi"):
        fs.sync_extract_topk_tm(*planes, fmt, 2, commit_hi=140 - 31)
    with pytest.raises(ValueError, match="shorter"):
        fs.sync_extract_topk_tm(torch.zeros((20, 3)), torch.zeros((20, 3)),
                                fmt, 2)
    # Zero planes: no energy, no peaks; empty slots report pos 0 and ang 0.
    out = fs.sync_extract_topk_tm(*planes, fmt, 2)
    assert not out.found.any() and not out.count.any()
    assert not out.pos.any() and not out.ang.any()
