"""Mesh helpers for the (channel, time) shard grid, and :func:`shard_map`
(port of ``psk_soft_tpu/parallel/mesh.py:1-37`` and of the
``jax.shard_map`` calls of ``psk_soft_tpu/parallel``).

The two parallel axes of the domain:

* ``chan``: independent demod chains -- embarrassingly parallel, no
  communication.
* ``time``: one stream's time axis split across shards; the sequential
  carries become halo exchanges + prefix combines at block seams
  (parallel/sharded.py).

A :class:`Mesh` is a (chan, time) grid of shards.  Each shard is a
``torch.device`` owned by a process rank.  The device list may repeat a
device (``["cpu"] * 8``, ``[torch.device("cuda:0")] * 4``): the port's
form of JAX's virtual devices.  :func:`shard_map` runs a body once per
shard this process owns; inside the body :func:`axis_index`,
:func:`axis_size` (JAX's ``psum(1, axis)``), :func:`ppermute` and
:func:`all_gather` act for the calling shard with JAX's semantics: a shard
that no one sends to receives zeros, and ``all_gather`` stacks in axis
order.

* Within one process a body that communicates runs as one thread per
  shard, and the collectives meet at a barrier.  A shard that raises
  aborts the barrier and its exception is re-raised in the caller; a
  collective that some shard never reaches fails after SHARD_TIMEOUT_S
  seconds.  Shards on one card share its current stream, so a tensor one
  shard hands another is ordered behind the launches that made it.
* Across processes the collectives go through ``torch.distributed``
  (``batch_isend_irecv`` for :func:`ppermute`, ``all_gather``): NCCL on
  GPUs, gloo on the CPU.  That needs one shard per process, PyTorch's
  one-process-per-GPU idiom (NCCL refuses two ranks on one GPU); a body
  that communicates on a mesh that breaks it raises ``ValueError``.
* A communication-free body (``collectives=False``: the chan axis) runs
  the shards in a loop, in any layout.

Arguments are split by their specs (:class:`PartitionSpec`) onto the
shards' devices; a :class:`Sharded` argument (:func:`shard`) hands its
parts over as they are.  Outputs come back whole (:func:`unshard`) when
every shard is this process's and no argument came in sharded; otherwise
as :class:`Sharded` parts, as JAX keeps a sharded array sharded.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

AXES = ("chan", "time")
SHARD_TIMEOUT_S = 600.0      # how long a collective waits for every shard


class PartitionSpec(tuple):
    """The mesh axis that splits each tensor dimension (None: not split),
    as ``jax.sharding.PartitionSpec``; dimensions past its length are not
    split, and an axis no dimension names replicates the tensor over it."""

    def __new__(cls, *axes):
        for a in axes:
            if a is not None and a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r}; the axes are "
                                 f"{AXES}")
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """A (chan, time) grid of shards: ``devices[c, t]`` is shard (c, t)'s
    ``torch.device`` and ``ranks[c, t]`` the process that owns it (default:
    this one)."""

    def __init__(self, devices, ranks=None):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2:
            raise ValueError(f"devices must be a (chan, time) grid, got "
                             f"shape {grid.shape}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = torch.device(grid[idx])
        self.ranks = (np.full(grid.shape, _rank(), np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(grid.shape))
        self.shape = dict(zip(AXES, grid.shape))
        self.size = int(grid.size)

    def coords(self) -> list:
        """Every shard's (chan, time) coordinates, chan-major."""
        return list(np.ndindex(self.devices.shape))

    def local_coords(self) -> list:
        """The shards this process owns, chan-major."""
        me = _rank()
        return [co for co in self.coords() if self.ranks[co] == me]

    @property
    def is_local(self) -> bool:
        """True when this process owns every shard."""
        return bool((self.ranks == _rank()).all())

    def __repr__(self) -> str:
        return (f"Mesh(chan={self.shape['chan']}, time={self.shape['time']}"
                f", devices={sorted({str(d) for d in self.devices.flat})}, "
                f"ranks={sorted({int(r) for r in self.ranks.flat})})")


def local_devices() -> list:
    """This process's CUDA devices (the default shard devices); raises when
    there is none: a mesh of CPU shards is asked for by name."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device: pass devices=['cpu'] * n for a "
                           "mesh of CPU shards")
    return [torch.device("cuda", i) for i in range(n)]


def shard_devices(device, n: int) -> list:
    """``n`` shard devices on ``device``: "cuda" cycles this process's CUDA
    devices (one card repeated n times on a one-card machine); "cpu" or
    "cuda:k" repeats that device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        devs = local_devices()
        return [devs[i % len(devs)] for i in range(n)]
    return [device] * n


def make_mesh(chan: int = 1, time: int = 1, devices=None) -> Mesh:
    """A chan x time mesh over the first chan*time of ``devices`` (default:
    this process's CUDA devices), every shard this process's."""
    devices = local_devices() if devices is None else list(devices)
    if chan * time > len(devices):
        raise ValueError(
            f"mesh {chan}x{time} needs {chan * time} devices, have "
            f"{len(devices)}")
    grid = np.empty(chan * time, dtype=object)
    for i, d in enumerate(devices[:chan * time]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(chan, time))


class NamedSharding(NamedTuple):
    """A mesh and a spec, as ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """(C, T) tensors sharded over channels only."""
    return NamedSharding(mesh, P("chan", None))


def chan_time_sharding(mesh: Mesh) -> NamedSharding:
    """(C, T) tensors sharded over both channels and time."""
    return NamedSharding(mesh, P("chan", "time"))


class Sharded:
    """A tensor split over a mesh by ``spec``: ``parts[coords]`` is the
    part of each shard this process owns, on that shard's device;
    ``shape`` the whole tensor's."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec, shape: tuple,
                 parts: dict):
        self.mesh, self.spec = mesh, spec
        self.shape = tuple(shape)
        self.parts = parts

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec!r}, "
                f"parts={len(self.parts)} of {self.mesh.size})")


def _blocks(shape, spec: PartitionSpec, mesh: Mesh, coords) -> tuple:
    """The index of shard ``coords``'s part of a tensor of ``shape``."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than the "
                         f"tensor's {len(shape)} dimensions")
    idx = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            idx.append(slice(None))
            continue
        k = mesh.shape[ax]
        if n % k:
            raise ValueError(f"dimension {d} of size {n} does not split "
                             f"over the {k} shards of axis {ax!r}")
        i = coords[AXES.index(ax)]
        idx.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(idx)


def _split(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh, coords):
    return x[_blocks(x.shape, spec, mesh, coords)].to(
        mesh.devices[coords]).contiguous()


def shard(x, sharding: NamedSharding) -> Sharded:
    """Split ``x`` by the sharding's spec onto its mesh's devices (this
    process's shards only): ``jax.device_put(x, sharding)``."""
    mesh, spec = sharding
    x = torch.as_tensor(x)
    return Sharded(mesh, spec, tuple(x.shape),
                   {co: _split(x, spec, mesh, co)
                    for co in mesh.local_coords()})


def _assemble(parts: dict, spec: PartitionSpec, mesh: Mesh):
    """Put the parts of every shard back together, on the first shard's
    device."""
    dev = mesh.devices[mesh.coords()[0]]
    dims = [(d, ax) for d, ax in enumerate(spec) if ax is not None]
    blocks: dict = {}
    for co, t in parts.items():
        blocks.setdefault(tuple(co[AXES.index(ax)] for _, ax in dims), t)

    def build(prefix: tuple):
        if len(prefix) == len(dims):
            return blocks[prefix].to(dev)
        d, ax = dims[len(prefix)]
        return torch.cat([build(prefix + (i,))
                          for i in range(mesh.shape[ax])], dim=d)

    return build(())


def unshard(x):
    """The whole tensor of a :class:`Sharded` (every part must be this
    process's), on the first shard's device; anything else as it is."""
    if not isinstance(x, Sharded):
        return x
    if len(x.parts) != x.mesh.size:
        raise ValueError(f"unshard needs every shard's part; this process "
                         f"holds {len(x.parts)} of {x.mesh.size}")
    return _assemble(x.parts, x.spec, x.mesh)


# --- shard_map and the collectives ------------------------------------------

_tls = threading.local()


class _ShardCtx(NamedTuple):
    mesh: Mesh
    coords: tuple
    comm: object


def _ctx() -> _ShardCtx:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise RuntimeError("mesh collectives run only inside a shard_map "
                           "body")
    return ctx


def _peer(coords: tuple, ax: int, i: int) -> tuple:
    c = list(coords)
    c[ax] = i
    return tuple(c)


def axis_index(axis: str) -> int:
    """The calling shard's index along ``axis``."""
    return _ctx().coords[AXES.index(axis)]


def axis_size(axis: str) -> int:
    """The number of shards along ``axis`` (JAX's ``psum(1, axis)``)."""
    return _ctx().mesh.shape[axis]


def ppermute(t: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """Send ``t`` along ``axis`` by ``perm``, pairs (source index,
    destination index); returns what this shard receives, zeros of ``t``'s
    shape and type when no one sends to it."""
    ctx = _ctx()
    perm = [(int(s), int(d)) for s, d in perm]
    n = ctx.mesh.shape[axis]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"perm {perm} is not a permutation of part of "
                         f"range({n})")
    return ctx.comm.ppermute(ctx, t, AXES.index(axis), perm)


def all_gather(t: torch.Tensor, axis: str) -> torch.Tensor:
    """Every shard's ``t`` along ``axis``, stacked on a new leading
    dimension in axis order."""
    ctx = _ctx()
    return ctx.comm.all_gather(ctx, t, AXES.index(axis))


class _ThreadComm:
    """Collectives between the shard threads of one process."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: dict = {}

    def _exchange(self, coords: tuple, t: torch.Tensor) -> dict:
        self.slots[coords] = t
        self.barrier.wait()
        snap = dict(self.slots)
        self.barrier.wait()      # every shard has read before the next round
        return snap

    def ppermute(self, ctx, t, ax, perm):
        snap = self._exchange(ctx.coords, t)
        src = [s for s, d in perm if d == ctx.coords[ax]]
        if not src:
            return torch.zeros_like(t)
        return snap[_peer(ctx.coords, ax, src[0])].to(t.device, copy=True)

    def all_gather(self, ctx, t, ax):
        snap = self._exchange(ctx.coords, t)
        return torch.stack([snap[_peer(ctx.coords, ax, k)].to(t.device)
                            for k in range(ctx.mesh.devices.shape[ax])])


class _DistComm:
    """Collectives through torch.distributed, one shard per process.
    Complex tensors travel as their real views (gloo has no complex
    type)."""

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return torch.view_as_real(t) if t.is_complex() else t

    @staticmethod
    def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return torch.view_as_complex(t.contiguous()) if like.is_complex() \
            else t

    def ppermute(self, ctx, t, ax, perm):
        dist = torch.distributed
        i = ctx.coords[ax]
        send = self._wire(t)
        ranks = ctx.mesh.ranks
        ops, recv = [], None
        for s, d in perm:
            if s == i:
                ops.append(dist.P2POp(dist.isend, send,
                                      int(ranks[_peer(ctx.coords, ax, d)])))
            if d == i:
                recv = torch.empty_like(send)
                ops.append(dist.P2POp(dist.irecv, recv,
                                      int(ranks[_peer(ctx.coords, ax, s)])))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is None:
            return torch.zeros_like(t)
        return self._unwire(recv, t)

    def all_gather(self, ctx, t, ax):
        dist = torch.distributed
        send = self._wire(t)
        bufs = [torch.empty_like(send) for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, send)
        out = torch.stack([bufs[int(ctx.mesh.ranks[_peer(ctx.coords, ax, k)])]
                           for k in range(ctx.mesh.devices.shape[ax])])
        return self._unwire(out, t)


class _NoComm:
    """A communication-free shard_map: collectives are refused."""

    def _refuse(self, *_):
        raise ValueError("this shard_map was built with collectives=False; "
                         "its body must not communicate")

    ppermute = all_gather = _refuse


def _is_leaf_spec(spec) -> bool:
    return spec is None or isinstance(spec, PartitionSpec)


def _map_specs(spec, value, fn):
    """fn(leaf spec, value) over a tree of specs and the matching tree of
    values (tuples, lists and NamedTuples)."""
    if _is_leaf_spec(spec):
        return fn(spec, value)
    if not isinstance(value, (tuple, list)) or len(value) != len(spec):
        raise ValueError(f"specs {spec!r} do not match the values")
    items = [_map_specs(s, v, fn) for s, v in zip(spec, value)]
    return type(value)(*items) if hasattr(value, "_fields") \
        else type(value)(items)


def _collect(spec, trees: list, fn):
    """fn(leaf spec, [each shard's leaf]) over the shards' output trees."""
    if _is_leaf_spec(spec):
        return fn(spec, trees)
    first = trees[0]
    if not isinstance(first, (tuple, list)) or len(first) != len(spec):
        raise ValueError(f"out_specs {spec!r} do not match the body's "
                         f"outputs")
    items = [_collect(s, [t[i] for t in trees], fn)
             for i, s in enumerate(spec)]
    return type(first)(*items) if hasattr(first, "_fields") \
        else type(first)(items)


def _has_sharded(tree) -> bool:
    if isinstance(tree, Sharded):
        return True
    if isinstance(tree, (tuple, list)):
        return any(_has_sharded(v) for v in tree)
    return False


def _part(spec, value, mesh: Mesh, coords):
    if spec is None or value is None:
        return value
    if isinstance(value, Sharded):
        if value.spec != spec or value.mesh.shape != mesh.shape:
            raise ValueError(f"a {value!r} argument where the spec is "
                             f"{spec!r} on {mesh!r}")
        return value.parts[coords]
    if isinstance(value, (torch.Tensor, np.ndarray)):
        return _split(torch.as_tensor(value), spec, mesh, coords)
    return value


def _call(body, mesh: Mesh, coords: tuple, comm, args: tuple):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = _ShardCtx(mesh, coords, comm)
    try:
        return body(*args)
    finally:
        _tls.ctx = prev


def _run_threads(body, mesh: Mesh, local: list, args: dict) -> list:
    comm = _ThreadComm(len(local), SHARD_TIMEOUT_S)
    results = [None] * len(local)
    errors: list = [None] * len(local)

    def work(i: int, co: tuple):
        try:
            results[i] = _call(body, mesh, co, comm, args[co])
        except threading.BrokenBarrierError as e:
            errors[i] = e                 # another shard failed, or timeout
        except BaseException as e:        # noqa: BLE001  (re-raised below)
            errors[i] = e
            comm.barrier.abort()

    threads = [threading.Thread(target=work, args=(i, co), daemon=True,
                                name=f"shard-{co[0]}-{co[1]}")
               for i, co in enumerate(local)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    if first is not None:
        raise first
    broken = next((e for e in errors if e is not None), None)
    if broken is not None:
        raise RuntimeError(f"a collective waited {SHARD_TIMEOUT_S} s for "
                           f"shards that never reached it") from broken
    return results


def shard_map(body, mesh: Mesh, in_specs, out_specs, *,
              collectives: bool = True):
    """``jax.shard_map(body, mesh=mesh, in_specs=..., out_specs=...)``:
    returns ``run(*args)``, which calls ``body`` once per shard of this
    process on that shard's parts of the arguments and puts the outputs
    together by ``out_specs`` (a spec, or a tuple / NamedTuple of them; a
    None spec passes None through).  ``collectives=False`` declares a
    communication-free body, run as a loop over the shards (see the module
    docstring for the rest)."""
    single = _is_leaf_spec(in_specs)

    def run(*args):
        specs = (in_specs,) if single else tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} arguments for {len(specs)} "
                             f"in_specs")
        local = mesh.local_coords()
        if not local:
            raise ValueError(f"process {_rank()} owns no shard of {mesh!r}")
        shard_args = {co: _map_specs(specs, args, lambda s, v, co=co:
                                     _part(s, v, mesh, co))
                      for co in local}
        if not collectives:
            outs = [_call(body, mesh, co, _NoComm(), shard_args[co])
                    for co in local]
        elif not mesh.is_local:
            if len(local) > 1:
                raise ValueError(
                    f"a body that communicates across processes needs one "
                    f"shard per process; process {_rank()} owns "
                    f"{len(local)} shards of {mesh!r} (NCCL refuses two "
                    f"ranks on one GPU)")
            world = torch.distributed.get_world_size()
            if sorted(mesh.ranks.flat) != list(range(world)):
                raise ValueError(f"a body that communicates across "
                                 f"processes needs every one of the "
                                 f"{world} processes to own one shard of "
                                 f"{mesh!r}")
            outs = [_call(body, mesh, local[0], _DistComm(),
                          shard_args[local[0]])]
        elif len(local) == 1:
            outs = [_call(body, mesh, local[0],
                          _ThreadComm(1, SHARD_TIMEOUT_S),
                          shard_args[local[0]])]
        else:
            outs = _run_threads(body, mesh, local, shard_args)
        whole = mesh.is_local and not _has_sharded(args)

        def leaf(spec, values):
            if spec is None or values[0] is None:
                return None
            parts = dict(zip(local, values))
            if whole:
                return _assemble(parts, spec, mesh)
            shape = [n * (mesh.shape[spec[d]] if d < len(spec)
                          and spec[d] is not None else 1)
                     for d, n in enumerate(values[0].shape)]
            return Sharded(mesh, spec, tuple(shape), parts)

        return _collect(out_specs, outs, leaf)

    return run
