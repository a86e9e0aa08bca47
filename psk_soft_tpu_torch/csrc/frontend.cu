// Kernel B5 for Hopper (sm_90a): the timing frontend of the fused pipeline.
//
// Replaces the Pallas kernel psk_soft_tpu/ops/pallas/frontend.py
// (timing_frontend_tm, body _kernel).  Over time-major (rows, C) float32
// I/Q planes, the carry window followed by the block, it computes per
// channel c and output symbol o:
//   e[r]     = re[r]^2 + im[r]^2                         (per sample)
//   W[o, j]  = sum_{t=o}^{o+num_avg-1} e[t*sps + j]      (per bin j < sps)
//   idx[o]   = first argmax_j W[o, j]   (NaN counts as the maximum)
//   sel[o]   = x[o*sps + idx[o]]                         (re and im)
// and writes sel_re, sel_im (S, C) float32 and idx (S, C) int32.
//
// Design: the block loop of timing.cuh, shared with kernel B1's stage A.
// One block of 512 threads owns a group of 8 channels (a 32-byte sector of
// each row) for the whole block of symbols, stages the stream by cp.async
// in chunks of up to 64 symbols (double-buffered: the next chunk's copy
// runs under the current chunk's work), carries each (bin, channel) window
// sum through the block as the difference of two running sums, and takes
// the first-max bin and its sample from shared memory.  So the sums keep the
// plain version's non-finite rule (a poisoned channel picks as the plain
// version does), no tile re-reads a halo, and no thread walks a chain of
// device-memory loads.  The Pallas kernel's 128-lane grid, DMA halo and
// log-step cumsum are TPU workarounds and are not carried over; its
// s_tile restart is not either (ROADMAP C).
//
// What bounds it on an H100: it must read the planes once (2 * 4 bytes *
// (S + num_avg - 1) * sps * C: 40 MB at 1024 channels x 512 symbols, sps 8,
// num_avg 100) and write 12 bytes per (symbol, channel) (6.3 MB): about
// 14 us of HBM time.  Each row also reaches the block a second time,
// num_avg symbols later, as it leaves the sums (the planes fit the 50 MB
// L2), and 1024 channels make 128 blocks, one wave on 132 SMs; a chunk's
// phases (staging, sums, argmax) run one after another, so each chunk
// also pays its barriers' latency (PERF.md section 6 has the times).

#include <cuda_runtime.h>
#include <stdint.h>

#include "timing.cuh"

namespace {

struct Params {
  psk::TwoPlanes in;
  float* sel_re;
  float* sel_im;
  int32_t* idx;
  int S, sps, num_avg, group, chunk, vec;
};

struct FrontEmit {
  const Params& p;
  __device__ __forceinline__ void operator()(int o, int c, int b, float re,
                                             float im) const {
    const int64_t out = (int64_t)o * p.in.C + c;
    p.sel_re[out] = re;
    p.sel_im[out] = im;
    p.idx[out] = b;
  }
};

__global__ void __launch_bounds__(psk::kTimingThreads)
frontend_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  psk::timing_block(p.in, p.S, p.sps, p.num_avg, p.group, p.chunk, p.vec,
                    smem, FrontEmit{p}, psk::NoNote{});
}

}  // namespace

// Dynamic shared memory per block of this plan.
extern "C" int64_t psk_timing_frontend_smem(int sps, int group, int chunk) {
  return psk::timing_smem_bytes(sps, group, chunk);
}

// Launch on `stream`.  Pointers are device pointers; the window holds
// win_rows = (num_avg - 1) * sps rows (0 allowed).  (group, chunk, vec) is
// the plan of ops/cuda/demod_kernel.timing_plan, checked here.  Returns 0
// once launched, cudaErrorInvalidValue for arguments or a plan the kernel
// does not take, or the error of the launch (cudaGetLastError()).
extern "C" int psk_timing_frontend_tm(
    const float* win_re, const float* win_im, int64_t win_rows,
    const float* x_re, const float* x_im, float* sel_re, float* sel_im,
    int32_t* idx, int C, int S, int sps, int num_avg, int group, int chunk,
    int vec, void* stream) {
  Params p;
  p.in = psk::TwoPlanes{win_re, win_im, x_re, x_im, win_rows, C};
  if (C < 1 || S < 1 || sps < 2 || num_avg < 1
      || win_rows != (int64_t)(num_avg - 1) * sps
      || psk::timing_plan_error(p.in, sps, group, chunk, vec))
    return (int)cudaErrorInvalidValue;
  p.sel_re = sel_re;
  p.sel_im = sel_im;
  p.idx = idx;
  p.S = S;
  p.sps = sps;
  p.num_avg = num_avg;
  p.group = group;
  p.chunk = chunk;
  p.vec = vec;
  const int64_t smem = psk::timing_smem_bytes(sps, group, chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  frontend_kernel<<<(C + group - 1) / group, psk::kTimingThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block may use on the current device.
extern "C" int psk_timing_frontend_max_smem(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}
