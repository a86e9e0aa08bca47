"""Kernels B2, B3 and B4: the Viterbi decoder, hand-written CUDA for Hopper
(port of ``psk_soft_tpu/ops/pallas/viterbi_kernel.py:66-83, 312-520``).

Three pieces per kernel, as for every kernel of the port:

* ``csrc/viterbi.cu``: the CUDA C++ kernels (its header note says what
  bounds them on an H100), built with nvcc for sm_90a into
  ``build/psk_soft_tpu_torch/`` at first use and loaded with ctypes.  B2
  and B3 share one ACS core: a decode row's states in one warp's
  registers, LLRs staged ahead in shared memory; :func:`launch_plan` sizes
  their blocks in Python.  B4 composes the walk from segments walked back
  from every state; :func:`traceback_plan` sizes it and the kernels check
  the plan (``csrc/traceback_plan.h``).
* The plain-PyTorch versions :func:`viterbi_fused_ref`,
  :func:`viterbi_acs_ref` and :func:`viterbi_traceback_ref`, on any
  device, step by step as the Pallas bodies compute.
* The wrappers :func:`viterbi_fused` (B2), :func:`viterbi_acs` (B3) and
  :func:`viterbi_traceback` (B4).  A CPU tensor goes to the plain version;
  a CUDA tensor launches the kernel, and a failed build, load or launch
  raises.  Each wrapper's ``.launches`` counts its kernel launches.

The layouts and keyword arguments are the Pallas ones (LLRs (n, T_pad, B),
metrics (S, B), decisions (T_pad, S, B), bits (T_pad, B)), so the planes
compare directly.  The TPU's tiling arguments are not carried over:
``T_pad`` is the planes' length (>= ``t_actual``; rows past ``t_actual``
come back zero), and ``t_pad``, ``t_tile``, ``b_tile`` and ``interpret``
have no counterpart; B needs no lane padding.

:func:`viterbi_decode_kernel` is the twin of ``viterbi_decode_pallas``: the
fused kernel when the trellis is within its envelope (:func:`fused_fits`,
the port's own rule), the two-phase B3 + B4 path otherwise or whenever the
caller passes ``t_tile``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...utils.build import REPO_ROOT, build_shared, count_launch, load_once
from .demod_kernel import NVCC_FLAGS, TIMING_HEADER, nvcc_path, plane_align

SOURCE = REPO_ROOT / "psk_soft_tpu_torch" / "csrc" / "viterbi.cu"
MAX_N = 8                    # code outputs per step the kernels take
MAX_K = 10                   # 512 states
# Constants of csrc/viterbi.cu that the launch plan needs (chip_smoke.py
# holds the plan against the library's own, psk_viterbi_plan).
SMEM_LIMIT = 48 * 1024       # shared memory a block, without opting in
MAX_CHUNK = 64               # trellis steps a staged LLR chunk ...
SLACK = 2                    # ... and the steps past it the look-ahead reads
FUSED_WARPS = 8              # B2: warps a block ...
FUSED_MAX_ROWS = 64          # ... and at most this many rows (K <= 3)
FUSED_MAX_STEPS = 1472       # B2's longest trellis at K <= 9 ...
FUSED_MAX_STEPS_K10 = 704    # ... and at K10
ACS_ROWS = 8                 # B3: rows a block ...
WRITER_WARPS = 4             # ... and warps that stage and write out
# B4's plan (traceback_plan); csrc/traceback_plan.h holds the kernels' side.
PLAN_HEADER = REPO_ROOT / "psk_soft_tpu_torch" / "csrc" / "traceback_plan.h"
TB_ROWS = 32                 # rows a segment block (a 32-byte sector)
TB_WALK_WARPS = 16           # walker warps a block, at most
TB_COPY_WARPS = 3            # warps that stage the decision tiles
TB_BUFFERS = 4               # tiles in shared memory, three ahead
TB_TILE_BYTES = 24 * 1024    # bytes a tile, about ...
TB_MAX_CHUNK = 64            # ... and at most this many steps
TB_TARGET_BLOCKS = 256       # segment blocks wanted, about two an SM
TB_MIN_SEGMENT = 64          # steps a segment, at least (a multiple of 32)
TB_MAX_SEGMENTS = 32         # segments, at most (pass 2 chains their maps)


def butterfly_signs(code) -> np.ndarray:
    """(2S, n) float32 +/-1 expected-sign planes in butterfly row order.

    Row r = a*S + 2j + p is the transition (pred = 2j+p) -> (s' = (S/2)a +
    j), i.e. exp_flat[r] = exp[s', p] of ``ops/fec._trellis``."""
    from ..fec import _trellis

    _, exp = _trellis(code)                       # (S, 2, n)
    s = exp.shape[0]
    k1 = s // 2
    flat = np.zeros((2 * s, exp.shape[2]), np.float32)
    for sp in range(s):
        a, j = sp // k1, sp % k1
        for p in range(2):
            flat[a * s + 2 * j + p] = exp[sp, p]
    return flat


class LaunchPlan(NamedTuple):
    """How one launch of B2 or B3 is sized (``make_plan`` in
    csrc/viterbi.cu, which refuses the launches this refuses)."""
    lanes_per_row: int          # min(32, S/2)
    rows_per_warp: int          # 32 / lanes_per_row
    warps: int                  # ACS warps a block
    rows_per_block: int         # W = warps * rows_per_warp
    chunk: int                  # Tc: trellis steps a staged LLR chunk
    smem: int                   # dynamic shared memory a block, bytes
    grid: int                   # blocks
    threads: int                # threads a block (B3: + WRITER_WARPS)


def fused_max_steps(s_count: int) -> int:
    """The longest trellis the fused kernel takes for ``s_count`` states:
    1472 steps for K <= 9, 704 at K10.  Longer ones go to B3 + B4, so a
    decode's path does not depend on how the plan sizes B2's blocks."""
    return FUSED_MAX_STEPS_K10 if s_count > 256 else FUSED_MAX_STEPS


def launch_plan(s_count: int, n: int, t: int, b: int,
                fused: bool) -> LaunchPlan:
    """Pure-Python launch plan of :func:`viterbi_fused` (``fused``) or
    :func:`viterbi_acs` for ``s_count`` states, ``n`` code outputs, ``t``
    steps and ``b`` rows.  B2 starts from 8 warps a block (at most 64
    rows), B3 from :data:`ACS_ROWS` rows, each with chunks of up to 64
    steps; over :data:`SMEM_LIMIT` the plan halves the warps a block, then
    the chunk.  Raises ValueError for a launch the kernels refuse."""
    if (s_count < 2 or s_count > 2 ** (MAX_K - 1) or s_count & (s_count - 1)
            or not 1 <= n <= MAX_N or t < 0 or b < 0):
        raise ValueError(f"no Viterbi launch for S={s_count}, n={n}, t={t}, "
                         f"B={b}")
    if fused and t > fused_max_steps(s_count):
        raise ValueError(f"{t} steps of {s_count} states: over the fused "
                         f"kernel's {fused_max_steps(s_count)}")
    lanes = min(32, s_count // 2)
    per_warp = 32 // lanes
    slots = s_count // lanes
    want = min(FUSED_WARPS * per_warp, FUSED_MAX_ROWS) if fused else ACS_ROWS
    warps = max(1, want // per_warp)

    def smem(warps, chunk):
        # Decision words in whole 32-step groups (B2: every step; B3: two
        # buffers of one chunk), then one LLR buffer, or two when the
        # trellis has more than one chunk, each with SLACK steps past the
        # chunk for the look-ahead.
        word_steps = -(-(t if fused else chunk) // 32) * 32
        word_buffers = 1 if fused else 2
        buffers = 2 if t > chunk else 1
        return 4 * (word_buffers * word_steps * warps * slots
                    + buffers * n * (chunk + SLACK) * warps * per_warp)

    chunk = min(MAX_CHUNK, max(t, 1))
    while smem(warps, chunk) > SMEM_LIMIT:
        if warps > 1:
            warps //= 2
        elif chunk > 1:
            chunk //= 2
        else:
            raise ValueError(f"{t} steps of {s_count} states need more than "
                             f"{SMEM_LIMIT} bytes of shared memory a block")
    w = warps * per_warp
    return LaunchPlan(lanes, per_warp, warps, w, chunk, smem(warps, chunk),
                      -(-b // w), 32 * (warps + (0 if fused else WRITER_WARPS)))


class TracebackPlan(NamedTuple):
    """How one launch of B4 is sized; csrc/traceback_plan.h checks it."""
    vec: int                    # bytes a staging copy moves: 16, 4 or 1
    chunk: int                  # Tc: trellis steps a staged tile
    seg_len: int                # steps a segment (a multiple of 32)
    segments: int               # segments over the t_actual - 1 steps
    smem: int                   # TB_BUFFERS tiles of (Tc, S, TB_ROWS) bytes
    grid: int                   # row groups x segments
    threads: int                # walker warps and TB_COPY_WARPS


def traceback_plan(s_count: int, b: int, t: int,
                   align: int = 16) -> TracebackPlan:
    """Launch plan of :func:`viterbi_traceback` for ``s_count`` states,
    ``b`` rows and ``t`` steps, the plane's base address a multiple of
    ``align`` bytes.  The walk is composed of segments of the t - 1 steps
    before the last (pass 2 takes the last from the start state): about
    TB_TARGET_BLOCKS blocks of TB_ROWS rows x one segment, at most
    TB_MAX_SEGMENTS, at least TB_MIN_SEGMENT steps each; copies of 16
    bytes where B and the address allow it, else 4, else 1; tiles of about
    TB_TILE_BYTES."""
    if (s_count < 2 or s_count > 2 ** (MAX_K - 1) or s_count & (s_count - 1)
            or t < 0 or b < 0):
        raise ValueError(f"no traceback launch for S={s_count}, t={t}, "
                         f"B={b}")
    vec = next(v for v in (16, 4, 1) if b % v == 0 and align % v == 0)
    steps = max(t - 1, 0)
    groups = -(-b // TB_ROWS)
    want = min(TB_MAX_SEGMENTS, max(1, -(-TB_TARGET_BLOCKS // max(groups, 1))))
    seg_len = max(TB_MIN_SEGMENT, -(-steps // (32 * want)) * 32)
    segments = -(-steps // seg_len)
    chunk = max(1, min(TB_MAX_CHUNK, TB_TILE_BYTES // (s_count * TB_ROWS),
                       seg_len))
    return TracebackPlan(vec, chunk, seg_len, segments,
                         TB_BUFFERS * chunk * s_count * TB_ROWS,
                         groups * segments,
                         32 * (min(s_count, TB_WALK_WARPS) + TB_COPY_WARPS))


def fused_smem_bytes(s_count: int, t: int, n: int = MAX_N) -> int:
    """Shared memory of one fused-kernel block (:func:`launch_plan`)."""
    return launch_plan(s_count, n, t, 0, True).smem


def fused_fits(s_count: int, t: int) -> bool:
    """Whether the fused kernel takes a ``t``-step trellis of ``s_count``
    states (:func:`fused_max_steps`); its plan then fits at every n."""
    return 0 <= t <= fused_max_steps(s_count)


def _check(llr_t, pm0, exp_flat, *, k, s_count, n, t_actual):
    if s_count != 1 << (k - 1) or not 2 <= k <= 10:
        raise ValueError(f"s_count {s_count} does not match K={k}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n={n} outside [1, {MAX_N}]")
    if any(t.dtype != torch.float32 for t in (llr_t, pm0, exp_flat)):
        raise ValueError("llr_t, pm0 and exp_flat must be float32")
    if llr_t.ndim != 3 or llr_t.shape[0] != n:
        raise ValueError(f"llr_t must be (n={n}, T_pad, B), got "
                         f"{tuple(llr_t.shape)}")
    _, t_pad, b = llr_t.shape
    if pm0.shape != (s_count, b) or exp_flat.shape != (2 * s_count, n):
        raise ValueError(f"pm0 must be {(s_count, b)} and exp_flat "
                         f"{(2 * s_count, n)}")
    if not 0 <= t_actual <= t_pad:
        raise ValueError(f"t_actual {t_actual} outside [0, {t_pad}]")
    if any(t.device != llr_t.device for t in (pm0, exp_flat)):
        raise ValueError("llr_t, pm0 and exp_flat must be on one device")


def _check_traceback(dec, start, *, k, s_count, t_actual):
    if s_count != 1 << (k - 1) or not 2 <= k <= 10:
        raise ValueError(f"s_count {s_count} does not match K={k}")
    if dec.ndim != 3 or dec.shape[1] != s_count:
        raise ValueError(f"dec must be (T_pad, S={s_count}, B), got "
                         f"{tuple(dec.shape)}")
    if dec.dtype != torch.int8 or start.dtype != torch.int32:
        raise ValueError("dec must be int8 and start int32")
    if start.shape != (1, dec.shape[2]) or start.device != dec.device:
        raise ValueError(f"start must be (1, {dec.shape[2]}) on dec's "
                         f"device")
    if not 0 <= t_actual <= dec.shape[0]:
        raise ValueError(f"t_actual {t_actual} outside [0, {dec.shape[0]}]")


# -- plain versions -----------------------------------------------------------

def _acs_steps(llr_t, pm0, exp_flat, s_count: int, n: int, t_actual: int):
    """The ACS recursion of ``_acs_step``: (list of (S, B) bool decisions,
    final re-zeroed metrics)."""
    pm = pm0
    decs = []
    for t in range(t_actual):
        bm = exp_flat[:, 0:1] * llr_t[0, t]               # (2S, B)
        for j in range(1, n):
            bm = bm + exp_flat[:, j:j + 1] * llr_t[j, t]
        cand0 = pm + bm[:s_count]
        cand1 = pm + bm[s_count:]
        c0 = torch.cat([cand0[0::2], cand1[0::2]])
        c1 = torch.cat([cand0[1::2], cand1[1::2]])
        dec = c1 > c0                                     # strict: tie -> 0
        new = torch.where(dec, c1, c0)
        pm = new - new[0:1]                               # re-zero
        decs.append(dec)
    return decs, pm


def _walk_back(decs, start, *, k: int, s_count: int, t_actual: int,
               t_pad: int) -> torch.Tensor:
    """Survivor walk from ``start`` (B,) over decs[t] (S, B) -> (T_pad, B)
    int8 bits, rows past t_actual zero.  A start outside [0, S) follows
    the Pallas ``_back_kernel``: its bit from the raw value (an arithmetic
    shift), decision 0 (the one-hot lookup matches no state)."""
    b = start.shape[0]
    bits = torch.zeros((t_pad, b), dtype=torch.int8, device=start.device)
    s = start.to(torch.int64)
    inside = (s >= 0) & (s < s_count)
    for t in range(t_actual - 1, -1, -1):
        bits[t] = ((s >> (k - 2)) & 1).to(torch.int8)
        d = torch.gather(decs[t], 0, (s & (s_count - 1))[None])[0] != 0
        s = ((s << 1) & (s_count - 1)) | (d & inside).to(torch.int64)
        inside = True                     # every later state lies in [0, S)
    return bits


def viterbi_fused_ref(llr_t, pm0, exp_flat, *, k: int, s_count: int, n: int,
                      t_actual: int, terminate: bool) -> torch.Tensor:
    """Plain-PyTorch version of :func:`viterbi_fused`."""
    _check(llr_t, pm0, exp_flat, k=k, s_count=s_count, n=n,
           t_actual=t_actual)
    decs, pm = _acs_steps(llr_t, pm0, exp_flat, s_count, n, t_actual)
    start = (torch.zeros(pm.shape[1], dtype=torch.int64, device=pm.device)
             if terminate else torch.argmax(pm, dim=0))
    return _walk_back(decs, start, k=k, s_count=s_count, t_actual=t_actual,
                      t_pad=llr_t.shape[1])


def viterbi_acs_ref(llr_t, pm0, exp_flat, *, k: int, s_count: int, n: int,
                    t_actual: int):
    """Plain-PyTorch version of :func:`viterbi_acs`."""
    _check(llr_t, pm0, exp_flat, k=k, s_count=s_count, n=n,
           t_actual=t_actual)
    decs, pm = _acs_steps(llr_t, pm0, exp_flat, s_count, n, t_actual)
    dec = torch.zeros((llr_t.shape[1], s_count, llr_t.shape[2]),
                      dtype=torch.int8, device=llr_t.device)
    if decs:
        dec[:t_actual] = torch.stack(decs).to(torch.int8)
    return dec, pm


def viterbi_traceback_ref(dec, start, *, k: int, s_count: int,
                          t_actual: int) -> torch.Tensor:
    """Plain-PyTorch version of :func:`viterbi_traceback`."""
    _check_traceback(dec, start, k=k, s_count=s_count, t_actual=t_actual)
    return _walk_back(dec, start[0], k=k, s_count=s_count,
                      t_actual=t_actual, t_pad=dec.shape[0])


# -- kernels ------------------------------------------------------------------

@load_once
def load_library():
    """Build (at first use) and load the kernel library.  Returns
    (ctypes library, compiler output of this build or "")."""
    path, log = build_shared(SOURCE, "viterbi", [nvcc_path()], NVCC_FLAGS,
                             headers=(TIMING_HEADER, PLAN_HEADER))
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.psk_viterbi_fused.restype = i32
    lib.psk_viterbi_fused.argtypes = [vp] * 4 + [i32] * 7 + [vp]
    lib.psk_viterbi_acs.restype = i32
    lib.psk_viterbi_acs.argtypes = [vp] * 5 + [i32] * 6 + [vp]
    lib.psk_viterbi_plan.restype = i32
    lib.psk_viterbi_plan.argtypes = [i32] * 5 + [vp]
    lib.psk_viterbi_traceback.restype = i32
    lib.psk_viterbi_traceback.argtypes = [vp] * 5 + [i32] * 11 + [vp]
    return lib, log


@load_once
def load_plan_check():
    """The kernel's own check of B4's plan (csrc/traceback_plan.h), built
    with the host C++ compiler, so it runs without a card.  Returns the
    ctypes function ``psk_traceback_plan_error(S, t_actual, B, *plan)``:
    0 for a plan the kernels take."""
    path, _ = build_shared(PLAN_HEADER, "traceback_plan", ["g++"],
                           ["-x", "c++", "-std=c++17", "-O1", "-shared",
                            "-fPIC", "-DPSK_TRACEBACK_PLAN_ONLY"])
    fn = ctypes.CDLL(str(path)).psk_traceback_plan_error
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 10
    return fn


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _cuda_device(*tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    return dev


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def viterbi_fused(llr_t, pm0, exp_flat, *, k: int, s_count: int, n: int,
                  t_actual: int, terminate: bool) -> torch.Tensor:
    """B2: (n, T_pad, B) LLRs, (S, B) initial metrics, (2S, n) butterfly
    signs -> (T_pad, B) int8 bits, ACS and traceback in one launch.

    The traceback starts at state 0 when ``terminate``, else at the first
    maximum of the final metrics.  Raises ValueError when the kernel does
    not take the trellis (:func:`fused_fits`)."""
    if llr_t.device.type == "cpu":
        return viterbi_fused_ref(llr_t, pm0, exp_flat, k=k, s_count=s_count,
                                 n=n, t_actual=t_actual, terminate=terminate)
    dev = _cuda_device(llr_t, pm0, exp_flat)
    _check(llr_t, pm0, exp_flat, k=k, s_count=s_count, n=n,
           t_actual=t_actual)
    if not fused_fits(s_count, t_actual):
        raise ValueError(f"{t_actual} steps of {s_count} states: over the "
                         f"fused kernel's {fused_max_steps(s_count)}; use "
                         f"viterbi_acs + viterbi_traceback")
    _, t_pad, b = llr_t.shape
    lib, _ = load_library()
    with torch.cuda.device(dev):
        bits = torch.empty((t_pad, b), dtype=torch.int8, device=dev)
        if t_actual < t_pad:
            bits[t_actual:].zero_()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.psk_viterbi_fused(
            _ptr(llr_t), _ptr(pm0), _ptr(exp_flat), _ptr(bits), n, s_count,
            k, t_pad, t_actual, b, int(bool(terminate)),
            ctypes.c_void_p(stream))
    _raise_on(rc, "viterbi_fused")
    count_launch(viterbi_fused)
    return bits


def viterbi_acs(llr_t, pm0, exp_flat, *, k: int, s_count: int, n: int,
                t_actual: int):
    """B3: (n, T_pad, B) LLRs -> ((T_pad, S, B) int8 decisions, (S, B)
    final metrics), the metrics carried over the whole trellis."""
    if llr_t.device.type == "cpu":
        return viterbi_acs_ref(llr_t, pm0, exp_flat, k=k, s_count=s_count,
                               n=n, t_actual=t_actual)
    dev = _cuda_device(llr_t, pm0, exp_flat)
    _check(llr_t, pm0, exp_flat, k=k, s_count=s_count, n=n,
           t_actual=t_actual)
    _, t_pad, b = llr_t.shape
    lib, _ = load_library()
    with torch.cuda.device(dev):
        dec = torch.empty((t_pad, s_count, b), dtype=torch.int8, device=dev)
        if t_actual < t_pad:
            dec[t_actual:].zero_()
        pm = torch.empty((s_count, b), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.psk_viterbi_acs(
            _ptr(llr_t), _ptr(pm0), _ptr(exp_flat), _ptr(dec), _ptr(pm), n,
            s_count, k, t_pad, t_actual, b, ctypes.c_void_p(stream))
    _raise_on(rc, "viterbi_acs")
    count_launch(viterbi_acs)
    return dec, pm


def viterbi_traceback(dec, start, *, k: int, s_count: int,
                      t_actual: int) -> torch.Tensor:
    """B4: (T_pad, S, B) int8 decisions (nonzero = 1) and (1, B) int32
    start states -> (T_pad, B) int8 bits; bit t is the input bit that
    entered the state after step t.  A start outside [0, S) takes its
    first bit from the raw value and reads decision 0 at that step, as the
    Pallas kernel does."""
    if dec.device.type == "cpu":
        return viterbi_traceback_ref(dec, start, k=k, s_count=s_count,
                                     t_actual=t_actual)
    dev = _cuda_device(dec, start)
    _check_traceback(dec, start, k=k, s_count=s_count, t_actual=t_actual)
    t_pad, _, b = dec.shape
    plan = traceback_plan(s_count, b, t_actual, plane_align(dec))
    lib, _ = load_library()
    with torch.cuda.device(dev):
        bits = torch.empty((t_pad, b), dtype=torch.int8, device=dev)
        if t_actual < t_pad:
            bits[t_actual:].zero_()
        steps = max(t_actual - 1, 0)
        words = torch.empty((-(-steps // 32), s_count, b), dtype=torch.int32,
                            device=dev)
        fmap = torch.empty((plan.segments, s_count, b), dtype=torch.int32,
                           device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.psk_viterbi_traceback(
            _ptr(dec), _ptr(start), _ptr(bits), _ptr(words), _ptr(fmap),
            s_count, k, t_actual, b, *plan, ctypes.c_void_p(stream))
    _raise_on(rc, "viterbi_traceback")
    count_launch(viterbi_traceback)
    return bits


viterbi_fused.launches = 0
viterbi_acs.launches = 0
viterbi_traceback.launches = 0


@functools.lru_cache(maxsize=None)
def _signs_on(code, device: torch.device) -> torch.Tensor:
    """:func:`butterfly_signs` of ``code`` on ``device``, uploaded once per
    (code, device): the chain decodes every block with the same code.  One
    tensor serves every caller, so nothing writes to it."""
    return torch.as_tensor(butterfly_signs(code), device=device)


def decode_planes(code, llrs):
    """The kernels' inputs for decoding (..., L) soft code bits:
    ((n, T, B) LLR planes after depuncturing, (S, B) metrics pinned to
    state 0, (2S, n) butterfly signs, T, the leading shape), on the
    device of ``llrs``."""
    from ..fec import depuncture

    y = depuncture(code, llrs)
    length = y.shape[-1]
    if length % code.n:
        raise ValueError(f"LLR length {length} not a multiple of n={code.n}")
    t = length // code.n
    steps = y.reshape(-1, t, code.n)
    dev = steps.device
    llr_t = steps.permute(2, 1, 0).contiguous()           # (n, T, B)
    exp = _signs_on(code, dev)
    pm0 = torch.full((code.states, llr_t.shape[2]), -1e9,
                     dtype=torch.float32, device=dev)
    pm0[0] = 0.0
    return llr_t, pm0, exp, t, y.shape[:-1]


def viterbi_decode_kernel(code, llrs, terminate: bool = True, *,
                          t_tile: int | None = None) -> torch.Tensor:
    """Kernel twin of ``ops/fec.viterbi_decode`` (the port's
    ``viterbi_decode_pallas``): (..., L) soft code bits -> (..., N) int8
    bits, puncturing undone first, flush bits stripped when ``terminate``.

    The fused kernel B2 decodes when the trellis fits it; otherwise, or
    whenever ``t_tile`` is given, B3 then B4 (with the trellis padded to a
    whole number of ``t_tile`` steps).  CPU tensors run the plain versions
    along the same dispatch."""
    llr_t, pm0, exp, t, lead = decode_planes(code, llrs)
    if terminate and t <= code.k - 1:
        raise ValueError(f"{t} trellis steps cannot carry K-1="
                         f"{code.k - 1} flush bits")
    s_count = code.states
    b = llr_t.shape[2]
    kw = dict(k=code.k, s_count=s_count, n=code.n, t_actual=t)
    if t_tile is None and fused_fits(s_count, t):
        bits = viterbi_fused(llr_t, pm0, exp, terminate=terminate, **kw)
    else:
        if t_tile is not None:
            if t_tile < 1:
                raise ValueError(f"t_tile must be >= 1, got {t_tile}")
            pad = (-t) % t_tile
            llr_t = torch.nn.functional.pad(llr_t, (0, 0, 0, pad))
        dec, pm = viterbi_acs(llr_t, pm0, exp, **kw)
        if terminate:
            start = torch.zeros((1, b), dtype=torch.int32, device=pm.device)
        else:
            start = torch.argmax(pm, dim=0).to(torch.int32)[None]
        bits = viterbi_traceback(dec, start, k=code.k, s_count=s_count,
                                 t_actual=t)
    bits = bits[:t].T
    if terminate:
        bits = bits[:, :t - (code.k - 1)]
    return bits.reshape(lead + (bits.shape[-1],))
