// The C2 timing stage shared by kernels B1 (demod_full.cu, its stage A) and
// B5 (frontend.cu): reading row r of the [window | block] planes through
// two pointers, per-sample energy, the first-max rule of the argmax, and
// the tile loops that turn a tile of output symbols into per-symbol
// decisions (window sums over num_avg symbols, first-max bin, emit).
#pragma once

#include <stdint.h>

namespace psk {

// Time-major (rows, C) float32 I/Q planes seen as one stream: rows
// [0, win_rows) come from `win`, the rest from `x`.  The window is the
// previous block's last rows (or a view of them), so nothing is
// concatenated in device memory.
struct TwoPlanes {
  const float* win_re;
  const float* win_im;
  const float* x_re;
  const float* x_im;
  int64_t win_rows;
  int C;

  __device__ __forceinline__ void sample(int64_t r, int c, float& re,
                                         float& im) const {
    if (r < win_rows) {
      re = win_re[r * C + c];
      im = win_im[r * C + c];
    } else {
      re = x_re[(r - win_rows) * C + c];
      im = x_im[(r - win_rows) * C + c];
    }
  }

  __device__ __forceinline__ float energy(int64_t r, int c) const {
    float re, im;
    sample(r, c, re, im);
    return re * re + im * im;
  }
};

// True when bin value v replaces `best` in a first-max scan over the bins
// in order: a strictly larger value, or the first NaN (NaN counts as the
// maximum, as torch.argmax and jnp.argmax treat it), so a poisoned window
// picks the same sample as the plain versions.
__device__ __forceinline__ bool takes_max(float v, float best) {
  return v > best || (v != v && best == best);
}

constexpr int kTimingLanes = 32;      // channels per block, bins layout
constexpr int kTimingChunk = 8;       // symbols per shared-memory exchange
constexpr int kTimingMaxBinsSps = 32; // bins layout: one warp per bin

// A per-sample hook that does nothing (kernel B5).  A hook is called as
// note(energy, symbol, bin, channel) once for every sample a tile adds to
// its window sums; symbol counts rows of [window | block] in symbols.
struct NoNote {
  __device__ __forceinline__ void operator()(float, int, int, int) const {}
};

// Bins layout (sps <= 32): block (32 channels, sps bins), thread (lane, j)
// owns channel blockIdx.x * 32 + lane and bin j over the output symbols
// [o0, o1) of tile blockIdx.y.  It sums its bin's first window directly
// (symbols [o0, o0 + num_avg)), then slides it one symbol at a time (add
// the entering symbol's energy, subtract the leaving one's).  Every
// kTimingChunk symbols the warps exchange their sums through `wbuf`
// (kTimingChunk * sps * 32 floats of shared memory) and each warp takes
// the first-max argmax of its own symbols of the chunk and calls
// emit(o, c, bin) once for each (symbol, channel).
template <class Emit, class Note>
__device__ __forceinline__ void timing_tile_bins(const TwoPlanes& in, int S,
                                                 int sps, int num_avg,
                                                 int tile, float* wbuf,
                                                 Emit emit, Note note) {
  const int lane = threadIdx.x;
  const int j = threadIdx.y;
  const int c = blockIdx.x * kTimingLanes + lane;
  const bool live = c < in.C;         // idle lanes still meet the barriers
  const int o0 = blockIdx.y * tile;
  const int o1 = min(o0 + tile, S);

  // Window sum of output symbol o0: symbols [o0, o0 + num_avg).
  float w = 0.f;
  if (live) {
#pragma unroll 4
    for (int t = o0; t < o0 + num_avg; ++t) {
      const float e = in.energy((int64_t)t * sps + j, c);
      note(e, t, j, c);
      w += e;
    }
  }
  for (int base = o0; base < o1; base += kTimingChunk) {
#pragma unroll
    for (int s = 0; s < kTimingChunk; ++s) {
      const int o = base + s;
      if (live && o > o0 && o < o1) { // slide to symbols [o, o + num_avg)
        const int t_in = o + num_avg - 1;
        const float e_in = in.energy((int64_t)t_in * sps + j, c);
        note(e_in, t_in, j, c);
        w = w + e_in - in.energy((int64_t)(o - 1) * sps + j, c);
      }
      wbuf[(s * sps + j) * kTimingLanes + lane] = w;
    }
    __syncthreads();
    for (int s = j; s < kTimingChunk; s += sps) {
      const int o = base + s;
      if (!live || o >= o1) continue;
      const float* col = wbuf + s * sps * kTimingLanes + lane;
      int b = 0;
      float best = col[0];
      for (int q = 1; q < sps; ++q) {
        const float v = col[q * kTimingLanes];
        if (takes_max(v, best)) { best = v; b = q; }
      }
      emit(o, c, b);
    }
    __syncthreads();
  }
}

// Wide layout (any sps; used for sps > 32, where the bins layout would
// exceed 1024 threads a block): one thread per (channel, tile), channel
// blockIdx.x * blockDim.x + threadIdx.x, its bins in its column of `smem`
// (sps * blockDim.x floats).  Same sums, slides, first-max and emit.
template <class Emit, class Note>
__device__ __forceinline__ void timing_tile_wide(const TwoPlanes& in, int S,
                                                 int sps, int num_avg,
                                                 int tile, float* smem,
                                                 Emit emit, Note note) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= in.C) return;
  const int stride = blockDim.x;
  const int o0 = blockIdx.y * tile;
  const int o1 = min(o0 + tile, S);
  float* w = smem + threadIdx.x;      // bin j at w[j * stride]

  for (int j = 0; j < sps; ++j) w[j * stride] = 0.f;
  for (int t = o0; t < o0 + num_avg; ++t)
    for (int j = 0; j < sps; ++j) {
      const float e = in.energy((int64_t)t * sps + j, c);
      note(e, t, j, c);
      w[j * stride] += e;
    }
  for (int o = o0; o < o1; ++o) {
    if (o > o0) {
      const int t_in = o + num_avg - 1;
      const int64_t r_in = (int64_t)t_in * sps;
      const int64_t r_out = (int64_t)(o - 1) * sps;
      for (int j = 0; j < sps; ++j) {
        const float e_in = in.energy(r_in + j, c);
        note(e_in, t_in, j, c);
        w[j * stride] = w[j * stride] + e_in - in.energy(r_out + j, c);
      }
    }
    int b = 0;
    float best = w[0];
    for (int j = 1; j < sps; ++j) {
      const float v = w[j * stride];
      if (takes_max(v, best)) { best = v; b = j; }
    }
    emit(o, c, b);
  }
}

}  // namespace psk
