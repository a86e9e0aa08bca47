"""Kernel B5: the timing frontend of the fused pipeline, hand-written CUDA
for Hopper (port of ``psk_soft_tpu/ops/pallas/frontend.py:42-134``).

Three pieces, as for every kernel of the port:

* ``csrc/frontend.cu``: the CUDA C++ kernel (its header note says what
  bounds it on an H100), built with nvcc for sm_90a into
  ``build/psk_soft_tpu_torch/`` at first use and loaded with ctypes.
* :func:`timing_frontend_tm_ref`: the same function in plain PyTorch on
  ``ops/timing`` (cumsum-diff window sums, first-max argmax, gather).
* :func:`timing_frontend_tm`: the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel, and a failed build, load or
  launch raises.  ``timing_frontend_tm.launches`` counts kernel launches.

The input is the [window | block] stream read through two pointers (the
carry window, then the block), as kernel B1 reads it, so the caller never
concatenates them.  The kernel carries each window sum through the block
as the difference of two running sums, the plain version takes cumsum
differences: NaN and inf give the same picks, and on a modulated signal
the argmax is well separated and the two agree exactly; where two bins'
sums differ by a few ulps (pure noise) they may pick different bins.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...ops import timing
from ...utils.build import build_shared
from .demod_kernel import (CSRC, NVCC_FLAGS, TIMING_HEADER, nvcc_path,
                           plane_align, timing_plan)

SOURCE = CSRC / "frontend.cu"


def _check_args(win_re, win_im, x_re, x_im, *, sps: int, num_avg: int):
    """Validate what both versions take; returns (S, C)."""
    if sps < 2:
        raise ValueError("timing frontend requires sps > 1")
    if num_avg < 1:
        raise ValueError("timing frontend requires num_avg >= 1")
    planes = (win_re, win_im, x_re, x_im)
    if any(t.dtype != torch.float32 or t.ndim != 2 for t in planes):
        raise ValueError("planes must be 2-D (rows, C) float32")
    if any(t.device != x_re.device for t in planes):
        raise ValueError("planes must be on one device")
    T, C = x_re.shape
    if x_im.shape != (T, C) or T == 0 or T % sps:
        raise ValueError(f"x planes must be (S*sps, C) with S >= 1, got "
                         f"{tuple(x_re.shape)} / {tuple(x_im.shape)}")
    wrows = (num_avg - 1) * sps
    if win_re.shape != (wrows, C) or win_im.shape != (wrows, C):
        raise ValueError(f"win planes must be {(wrows, C)}")
    return T // sps, C


def timing_frontend_tm_ref(win_re, win_im, x_re, x_im, *, sps: int,
                           num_avg: int):
    """Plain-PyTorch version of :func:`timing_frontend_tm` (same arguments
    and outputs), on any device."""
    S, C = _check_args(win_re, win_im, x_re, x_im, sps=sps, num_avg=num_avg)
    rows = S + num_avg - 1

    def cmajor(win, x):                       # (C, rows, sps)
        return torch.cat([win, x]).reshape(rows, sps, C).permute(2, 0, 1)

    xs = torch.complex(cmajor(win_re, x_re), cmajor(win_im, x_im))
    w = timing.windowed_bin_sums(timing.symbol_energy_rows(xs), num_avg)
    idx, sel = timing.select_decision_samples(xs[:, :S], w)
    return (sel.real.T.contiguous(), sel.imag.T.contiguous(),
            idx.T.contiguous())


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library.  Returns
    (ctypes library, compiler output of this build or "")."""
    path, log = build_shared(SOURCE, "frontend", [nvcc_path()], NVCC_FLAGS,
                             headers=(TIMING_HEADER,))
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.psk_timing_frontend_tm.restype = i32
    lib.psk_timing_frontend_tm.argtypes = (
        [vp, vp, i64, vp, vp, vp, vp, vp] + [i32] * 7 + [vp])
    lib.psk_timing_frontend_max_smem.restype = i32
    lib.psk_timing_frontend_max_smem.argtypes = []
    lib.psk_timing_frontend_smem.restype = i64
    lib.psk_timing_frontend_smem.argtypes = [i32] * 3
    return lib, log


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def timing_frontend_tm(win_re, win_im, x_re, x_im, *, sps: int,
                       num_avg: int):
    """Timing frontend over time-major planes.

    Args:
      win_re/win_im: ((num_avg-1)*sps, C) float32 carry window (the
        previous block's last rows; a view of them is fine).
      x_re/x_im: (S*sps, C) float32 block planes.
    Returns:
      (sel_re, sel_im, sample_index): each (S, C); row o is output symbol o
      (float32, float32, int32).

    CPU tensors take :func:`timing_frontend_tm_ref`; CUDA tensors launch
    the kernel on the current stream.
    """
    if x_re.device.type == "cpu":
        return timing_frontend_tm_ref(win_re, win_im, x_re, x_im, sps=sps,
                                      num_avg=num_avg)
    if x_re.device.type != "cuda":
        raise ValueError(f"unsupported device {x_re.device}")
    S, C = _check_args(win_re, win_im, x_re, x_im, sps=sps, num_avg=num_avg)
    planes = (win_re, win_im, x_re, x_im)
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("planes must be contiguous")
    dev = x_re.device
    plan = timing_plan(C, sps, plane_align(*planes))
    lib, _ = load_library()
    with torch.cuda.device(dev):
        if plan.smem > lib.psk_timing_frontend_max_smem():
            raise ValueError(f"sps {sps} needs {plan.smem} bytes of shared "
                             f"memory per block, more than this device "
                             f"allows")
        sel_re = torch.empty((S, C), dtype=torch.float32, device=dev)
        sel_im = torch.empty((S, C), dtype=torch.float32, device=dev)
        idx = torch.empty((S, C), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.psk_timing_frontend_tm(
            _ptr(win_re), _ptr(win_im), win_re.shape[0], _ptr(x_re),
            _ptr(x_im), _ptr(sel_re), _ptr(sel_im), _ptr(idx), C, S, sps,
            num_avg, *plan[:3], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"timing_frontend_tm launch failed: CUDA error "
                           f"{rc}")
    timing_frontend_tm.launches += 1
    return sel_re, sel_im, idx


timing_frontend_tm.launches = 0
