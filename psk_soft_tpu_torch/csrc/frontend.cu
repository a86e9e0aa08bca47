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
// Design.  One thread owns one (channel, bin) pair over a tile of
// consecutive output symbols: a block is 32 channels (the lanes of a warp,
// so every row read is one coalesced 128-byte segment) by sps bins (one
// warp per bin).  A thread sums its bin's first window directly (num_avg
// loads), then slides it one symbol at a time (add the entering symbol's
// energy, subtract the leaving one's, both re-read through L2).  Every
// kChunk symbols the warps exchange their sums through shared memory and
// each warp takes the first-max argmax and the decision-sample gather of
// its own symbols of the chunk.  The [window | block] reader, the
// first-max rule and the tile loops themselves are shared with kernel
// B1's stage A (timing.cuh), so the pipeline never concatenates the
// window in device memory.  For sps > 32 (a block would exceed 1024
// threads) one thread owns a channel's bins for its tile, with the sums
// in its column of shared memory.  The Pallas kernel's
// 128-lane grid, DMA halo and log-step cumsum are TPU workarounds and are
// not carried over.
//
// What bounds it on an H100: it must read the planes once (2 * 4 bytes *
// (S + num_avg - 1) * sps * C: 40 MB at 1024 channels x 512 symbols, sps 8,
// num_avg 100) and write 12 bytes per (symbol, channel) (6.3 MB): about
// 14 us of HBM time.  Tiles overlap by num_avg - 1 symbols, so each tile
// re-reads the rows of its first window from L2: (tile + num_avg - 1) /
// tile reads of each row (2.5 at the wrapper's 64-symbol tile there, 85 MB
// from L2).  The kernel is bound by that L2 traffic and by the latency of
// each thread's chain of loads, not by HBM bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "timing.cuh"

namespace {

constexpr int kLanes = psk::kTimingLanes;     // channels per block (bins)
constexpr int kChunk = psk::kTimingChunk;     // symbols per exchange
constexpr int kMaxBinsSps = psk::kTimingMaxBinsSps;
constexpr int kThreads = 128;     // channels per block (wide-sps kernel)

struct Params {
  psk::TwoPlanes in;
  float* sel_re;
  float* sel_im;
  int32_t* idx;
  int S, sps, num_avg, tile;
};

__device__ __forceinline__ void emit(const Params& p, int o, int c, int b) {
  float re, im;
  p.in.sample((int64_t)o * p.sps + b, c, re, im);
  const int64_t out = (int64_t)o * p.in.C + c;
  p.sel_re[out] = re;
  p.sel_im[out] = im;
  p.idx[out] = b;
}

// sps <= 32: block (32 channels, sps bins), dynamic shared memory
// wbuf[kChunk][sps][32].
__global__ void __launch_bounds__(kLanes * kMaxBinsSps)
frontend_bins_kernel(const Params p) {
  extern __shared__ float wbuf[];
  psk::timing_tile_bins(
      p.in, p.S, p.sps, p.num_avg, p.tile, wbuf,
      [&](int o, int c, int b) { emit(p, o, c, b); }, psk::NoNote{});
}

// sps > 32: one thread per (channel, tile), the bins in the thread's
// column of dynamic shared memory (sps * kThreads floats).
__global__ void __launch_bounds__(kThreads)
frontend_wide_kernel(const Params p) {
  extern __shared__ float smem[];
  psk::timing_tile_wide(
      p.in, p.S, p.sps, p.num_avg, p.tile, smem,
      [&](int o, int c, int b) { emit(p, o, c, b); }, psk::NoNote{});
}

}  // namespace

// Threads per (channel, tile) pair: sps for the bins kernel, 1 for the
// wide-sps kernel (the wrapper sizes the tile from it).
extern "C" int psk_timing_frontend_threads_per_tile(int sps) {
  return sps <= kMaxBinsSps ? sps : 1;
}

// Dynamic shared memory per block for this sps.
extern "C" int64_t psk_timing_frontend_smem(int sps) {
  return (int64_t)sizeof(float) * sps
         * (sps <= kMaxBinsSps ? kChunk * kLanes : kThreads);
}

// Launch on `stream`.  Pointers are device pointers; the window holds
// win_rows = (num_avg - 1) * sps rows (0 allowed).  Returns 0 once
// launched, cudaErrorInvalidValue for arguments the kernel does not take,
// or cudaGetLastError() after the launch.
extern "C" int psk_timing_frontend_tm(
    const float* win_re, const float* win_im, int64_t win_rows,
    const float* x_re, const float* x_im, float* sel_re, float* sel_im,
    int32_t* idx, int C, int S, int sps, int num_avg, int tile,
    void* stream) {
  if (C < 1 || S < 1 || sps < 2 || num_avg < 1 || tile < 1
      || (S + tile - 1) / tile > 65535
      || win_rows != (int64_t)(num_avg - 1) * sps)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.in = psk::TwoPlanes{win_re, win_im, x_re, x_im, win_rows, C};
  p.sel_re = sel_re;
  p.sel_im = sel_im;
  p.idx = idx;
  p.S = S;
  p.sps = sps;
  p.num_avg = num_avg;
  p.tile = tile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t smem = psk_timing_frontend_smem(sps);
  const int tiles = (S + tile - 1) / tile;
  if (sps <= kMaxBinsSps) {
    const dim3 grid((C + kLanes - 1) / kLanes, tiles);
    frontend_bins_kernel<<<grid, dim3(kLanes, sps), smem, s>>>(p);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          frontend_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((C + kThreads - 1) / kThreads, tiles);
    frontend_wide_kernel<<<grid, kThreads, smem, s>>>(p);
  }
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
