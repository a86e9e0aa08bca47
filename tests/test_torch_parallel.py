"""Port parity and contract, the mesh layer: psk_soft_tpu_torch/parallel/
{mesh,wideband} on meshes of CPU shards.

- wideband: make_sharded_channelize over 2, 4 and 8 time shards equals the
  port's one-shot channelize_block with a zero carry bit for bit (the
  seams add nothing, tests/test_channelizer.py:229) and JAX's sharded
  channelizer within 2e-5 (the FFTs sum in another order,
  tests/test_torch_channelizer.py).
- shard_map: JAX's collective semantics (a shard no one sends to receives
  zeros, all_gather stacks in axis order), on threads and in a loop; a
  shard that raises is re-raised at once, a collective some shard never
  reaches fails at the timeout; a communicating body on a mesh with two
  shards in one process of several is refused; shard/unshard round trips.
- the kernel wrappers' launch counters stay exact when 8 threads count at
  once, and a library loader runs once however many threads call it.
"""

import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu.ops.channelizer import prototype_taps as jax_taps
from psk_soft_tpu.parallel.mesh import make_mesh as jax_make_mesh
from psk_soft_tpu.parallel.wideband import \
    make_sharded_channelize as jax_sharded_channelize
from psk_soft_tpu_torch.ops.channelizer import (channelize_block,
                                                channelizer_init,
                                                prototype_taps)
from psk_soft_tpu_torch.ops.cuda import (demod_kernel, frontend_kernel,
                                         viterbi_kernel)
from psk_soft_tpu_torch.parallel import mesh as mesh_mod
from psk_soft_tpu_torch.parallel.mesh import (P, Mesh, NamedSharding,
                                              Sharded, all_gather,
                                              axis_index, axis_size,
                                              make_mesh, ppermute, shard,
                                              shard_devices, shard_map,
                                              unshard)
from psk_soft_tpu_torch.parallel.wideband import make_sharded_channelize
from psk_soft_tpu_torch.utils.build import count_launch, load_once

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n_time", [2, 4, 8])
def test_sharded_channelize_seam_invariance(n_time):
    C, K, B = 16, 6, 64 * n_time
    taps = prototype_taps(C, K)
    np.testing.assert_array_equal(taps, jax_taps(C, K))
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(B * C)
         + 1j * rng.standard_normal(B * C)).astype(np.complex64)
    _, ref = channelize_block(torch.from_numpy(taps),
                              channelizer_init(C, K, "cpu"),
                              torch.from_numpy(x))
    mesh = make_mesh(chan=1, time=n_time, devices=CPU8)
    y = make_sharded_channelize(taps, C, mesh)(
        torch.from_numpy(x).reshape(B, C))
    assert torch.equal(y, ref)
    jy = jax_sharded_channelize(jnp.asarray(taps), C, jax_make_mesh(
        chan=1, time=n_time))(jnp.asarray(x).reshape(B, C))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=2e-5)


@pytest.mark.parametrize("chan,time", [(1, 4), (2, 4), (4, 2), (1, 1)])
def test_collectives_follow_jax(chan, time):
    mesh = make_mesh(chan=chan, time=time, devices=CPU8)

    def body(x):
        t, n = axis_index("time"), axis_size("time")
        c = axis_index("chan")
        assert n == time and axis_size("chan") == chan
        assert torch.equal(x, torch.full((1, 1), 10.0 * c + t))
        right = ppermute(x, "time", [(i, i - 1) for i in range(1, n)])
        left = ppermute(x, "time", [(i, i + 1) for i in range(n - 1)])
        gathered = all_gather(x[0], "time")            # (n, 1)
        return right, left, gathered.T

    x = torch.tensor([[10.0 * c + t for t in range(time)]
                      for c in range(chan)])
    right, left, gathered = shard_map(
        body, mesh, in_specs=P("chan", "time"),
        out_specs=(P("chan", "time"), P("chan", "time"),
                   P("chan", "time")))(x)
    # the right neighbor's value; zeros where no one sends (edge shards)
    want_r = torch.cat([x[:, 1:], torch.zeros(chan, 1)], dim=1)
    want_l = torch.cat([torch.zeros(chan, 1), x[:, :-1]], dim=1)
    assert torch.equal(right, want_r) and torch.equal(left, want_l)
    # each shard's gather: every time shard's value in axis order
    assert torch.equal(gathered, x.repeat(1, time))


def test_communication_free_loop_and_specs():
    mesh = make_mesh(chan=4, time=2, devices=CPU8)
    seen = []

    def body(a, b, k):
        seen.append((axis_index("chan"), axis_index("time")))
        return a * k, (b + 1, None)

    a = torch.arange(8.0 * 6).reshape(8, 6)
    b = torch.arange(8)
    out_a, (out_b, none) = shard_map(
        body, mesh, in_specs=(P("chan", "time"), P("chan"), None),
        out_specs=(P("chan", "time"), (P("chan"), P("chan"))),
        collectives=False)(a, b, 3)
    assert seen == mesh.coords()                  # one call per shard
    assert torch.equal(out_a, a * 3) and torch.equal(out_b, b + 1)
    assert none is None
    with pytest.raises(ValueError, match="collectives=False"):
        shard_map(lambda x: ppermute(x, "time", []), mesh,
                  in_specs=P("chan"), out_specs=P("chan"),
                  collectives=False)(b)
    with pytest.raises(RuntimeError, match="inside a shard_map body"):
        axis_index("time")


def test_shard_unshard_round_trip():
    mesh = make_mesh(chan=2, time=4, devices=CPU8)
    x = torch.arange(4 * 8 * 3.0).reshape(4, 8, 3)
    s = shard(x, NamedSharding(mesh, P("chan", "time")))
    assert isinstance(s, Sharded) and len(s.parts) == 8
    assert s.parts[(1, 2)].shape == (2, 2, 3)
    assert torch.equal(s.parts[(1, 2)], x[2:4, 4:6])
    assert torch.equal(unshard(s), x)
    # sharded in, sharded out
    y = shard_map(lambda v: v * 2, mesh, in_specs=P("chan", "time"),
                  out_specs=P("chan", "time"))(s)
    assert isinstance(y, Sharded) and torch.equal(unshard(y), x * 2)
    with pytest.raises(ValueError, match="does not split"):
        shard(torch.zeros(3, 8), NamedSharding(mesh, P("chan", "time")))
    assert shard_devices("cpu", 3) == [torch.device("cpu")] * 3


def test_a_failing_shard_is_reraised_without_a_hang():
    mesh = make_mesh(chan=1, time=4, devices=CPU8)

    def body(x):
        if axis_index("time") == 2:
            raise KeyError("shard 2 fails before its collective")
        return ppermute(x, "time", [(i, i + 1) for i in range(3)])

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard 2 fails"):
        shard_map(body, mesh, in_specs=P(None, "time"),
                  out_specs=P(None, "time"))(torch.zeros(1, 4))
    assert time.perf_counter() - t0 < 10       # not the barrier's timeout


def test_a_collective_no_shard_reaches_times_out(monkeypatch):
    monkeypatch.setattr(mesh_mod, "SHARD_TIMEOUT_S", 0.5)
    mesh = make_mesh(chan=1, time=2, devices=CPU8)

    def body(x):
        if axis_index("time") == 0:
            return x                      # skips the collective
        return all_gather(x, "time")[0]

    with pytest.raises(RuntimeError, match="never reached"):
        shard_map(body, mesh, in_specs=P(None, "time"),
                  out_specs=P(None, "time"))(torch.zeros(1, 2))


def test_communicating_body_needs_one_shard_per_process():
    # Process 0 (this one) owns two shards of a mesh spread over two
    # processes: a body that communicates is refused before it runs; a
    # communication-free one runs its two shards.
    devs = np.empty((1, 3), dtype=object)
    devs[0] = [torch.device("cpu")] * 3
    mesh = Mesh(devs, ranks=[[0, 0, 1]])
    assert not mesh.is_local and mesh.local_coords() == [(0, 0), (0, 1)]
    x = torch.zeros(1, 3)
    with pytest.raises(ValueError, match="one shard per process"):
        shard_map(lambda v: ppermute(v, "time", [(0, 1)]), mesh,
                  in_specs=P(None, "time"), out_specs=P(None, "time"))(x)
    out = shard_map(lambda v: v + 1, mesh, in_specs=P(None, "time"),
                    out_specs=P(None, "time"), collectives=False)(x)
    assert isinstance(out, Sharded) and sorted(out.parts) == [(0, 0), (0, 1)]


def test_launch_counters_exact_under_threads():
    """More threads than cores, a short switch interval: a lost update
    would show in the counts."""
    wrappers = (demod_kernel.demod_full_tm, demod_kernel.matched_filter_tm,
                viterbi_kernel.viterbi_fused, viterbi_kernel.viterbi_acs,
                viterbi_kernel.viterbi_traceback,
                frontend_kernel.timing_frontend_tm)
    saved = [(w.launches, dict(getattr(w, "mode_launches", {})))
             for w in wrappers]
    switch = sys.getswitchinterval()
    try:
        for w in wrappers:
            w.launches = 0
        modes = dict.fromkeys(demod_kernel.demod_full_tm.mode_launches, 0)
        demod_kernel.demod_full_tm.mode_launches.update(modes)
        n_threads, n_each = max(8, (os.cpu_count() or 1) + 1), 400
        start = threading.Barrier(n_threads)
        sys.setswitchinterval(1e-6)

        def work():
            start.wait()
            for _ in range(n_each):
                for w in wrappers:
                    count_launch(w, ("int16", "mixed")
                                 if w is demod_kernel.demod_full_tm else ())

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        total = n_threads * n_each
        assert [w.launches for w in wrappers] == [total] * len(wrappers)
        assert demod_kernel.demod_full_tm.mode_launches == dict(
            modes, int16=total, mixed=total)
    finally:
        sys.setswitchinterval(switch)
        for w, (n, m) in zip(wrappers, saved):
            w.launches = n
            if m:
                w.mode_launches.update(m)


def test_loader_runs_once_under_threads():
    calls = []

    @load_once
    def load():
        calls.append(1)
        time.sleep(0.05)
        return object()

    got = []
    threads = [threading.Thread(target=lambda: got.append(load()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len({id(g) for g in got}) == 1
