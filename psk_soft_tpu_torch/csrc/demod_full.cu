// Kernel B1 for Hopper (sm_90a): the fused steady-state PSK demod.
//
// Replaces the Pallas kernel psk_soft_tpu/ops/pallas/demod_kernel.py
// (demod_full_tm, body _kernel).  One call over a block of time-major
// (T, C) float32 I/Q planes computes, per channel and per symbol:
//   windowed per-bin energy over num_avg symbols -> first-max argmax ->
//   decision-sample pick -> M-th power by log2(M) squarings + atan2f ->
//   9-tap complex moving-average trend -> prefix unwrap of the trend with
//   the residual re-attached -> phase_avg-tap endpoint linear-fit FIR ->
//   derotation by -est/M (+pi/4 for QPSK) or differential s*conj(p)/|p|^2
//   -> M-PSK slicing (LSB-first code) -> carry update with the M*2pi
//   re-wrap of the phase history.
// The carry plane layout is the Pallas kernel's state_rows layout:
//   rows [0, n1)            u history (oldest .. newest), n1 = phase_avg-1
//   rows [n1, n1+8)         trend cos history
//   rows [n1+8, n1+16)      trend sin history
//   rows misc+0 .. misc+3   ang_prev, unwrap_acc, last decision re, im
//   rows misc+4, misc+5     timing_interp: row S-1's last sample (written)
//   rows misc+6, misc+7     mixed: the channel's M and differential flag
//   other rows              passed through unchanged
//
// Modes (the Pallas kernel's static arguments):
//   int16 ingest   window and block planes are int16, dequantized as
//                  i16 * in_scale where a sample is read (timing.cuh);
//   timing_interp  stage A emits the circular-centroid pick, the sample
//                  interpolated between its two nearest samples;
//   matched filter a third launch first, stage 0 (demod_fir_kernel), filters
//                  the raw [window | block] rows (the window carries
//                  ntaps-1 extra raw rows) into float32 scratch, and
//                  stages A and B run on the filtered stream unchanged;
//   mixed          M and the differential flag per channel from carry rows
//                  misc+6 and misc+7: the M-th power, correction, slicing
//                  and re-wrap take the lane's values (a group of channels
//                  with different M diverges inside a warp).
//
// Design: two kernels on the caller's stream (three with a matched filter).
//
// Stage 0 (demod_fir_kernel, matched filter only; also launched alone by
// psk_matched_filter_tm), f[r] = sum_j taps[j] * raw[r + j] in tap order,
// one fmaf a tap from 0.  A block owns a strip of 32 channels and walks a
// run of rows in tiles of 16 * row_threads rows: each thread keeps 16
// consecutive outputs of one channel and a window of 24 raw samples per
// plane in registers, the taps taken 8 at a time (two broadcast float4
// reads of shared memory) with the group loop unrolled three times, so the
// window is a ring whose slots every fused multiply-add names at compile
// time: 8 new samples a plane come in a group and nothing moves.  The
// ntaps % 8 last taps read their samples from shared memory.  A tile's raw
// rows (tile + ntaps - 1, both planes, float32 or int16 as they arrive)
// are staged by cp.async into one of two buffers while the tile before is
// filtered; the ntaps - 1 rows the next tile shares with this one are
// copied across in shared memory, so a run reads its halo from L2 or HBM
// once.  The plan (row threads, run length, copy width) is made in Python
// (ops/cuda/demod_kernel.fir_plan) and checked here (fir_plan_error).
//
// Stage A (demod_timing_kernel), one block per group of channels over the
// whole block of symbols: kernel B5's block loop (timing.cuh: the stream
// staged by cp.async, window sums carried through the block as two running
// sums, the first-max bin and its sample), then per (symbol, channel) the
// M-th power and raw = atan2f.  It writes sel_re, sel_im, raw to (S, C)
// scratch and the sample index to its output plane.  Every sample that
// enters a window sum is checked: the first NaN and the first +inf energy
// symbol of each (bin, channel) go to `first_bad` with atomicMin (a branch
// never taken on finite input).
//
// Stage B (demod_track_kernel), one block per group of kGroup channels
// walking the block in chunks of `chunk` symbols, one thread per (symbol,
// channel) of a chunk.  All symbols of a chunk are computed at once: the
// 9-tap trend from the chunk's raws and the 8 before them, ang_t, the wrap
// count d[o] = rint((ang_t[o] - ang_t[o-1]) / 2pi), then u, the FIR over
// [u history | u], derotation, slicing and the outputs.  The only serial
// step is the prefix sum of d: a warp-shuffle scan inside a chunk, the
// warps' totals added through shared memory, the channel's running sum
// carried from chunk to chunk.  The scan is in float32 (exact for the
// integers it adds), so a NaN wrap count makes every later u of its
// channel NaN, as the plain version's cumsum does.  The trend, u and
// decision histories live in shared memory, (halo + chunk) rows per
// channel in two buffers used in turn, so shared memory does not grow
// with S.  The block that owns a channel writes its carry after the last
// chunk, with the M*2pi re-wrap from the last unwrapped phase.
//
// Non-finite samples.  The plain version takes window sums as cumsum
// differences from the start of [window | block], so a NaN energy at
// symbol t in bin j makes that bin's sum NaN for every output symbol o
// with o + num_avg - 1 >= t, and a +inf makes it inf while the window
// holds it and NaN once it has left (inf - inf).  Stage A's carried sums
// give that rule themselves; stage B also derives it from `first_bad` on a
// channel whose first non-finite symbol the window has reached (each bin
// NaN, inf or finite; the first NaN bin, else the first inf bin, else
// stage A's pick) and re-gathers the sample and its raw phase.  Finite
// channels skip it.
//
// What bounds it on an H100: the function must move about 45 MB per
// 1024 x 512-symbol block at sps 8 (33.5 MB of block planes, the 6.5 MB
// window, soft and bits out), about 14 us of HBM time.  Stage A reads each
// row a second time as it leaves the window sums (timing.cuh) and
// stage B walks S / chunk chunks with four barriers each, so the pair is
// bound by L2 traffic and by the latency of those chunk steps, not by HBM
// bytes.  The earlier
// design (one thread walking all S symbols of a channel, 1024 threads in
// all) was bound by the latency of each symbol's dependent chain.
//
// With a matched filter, stage 0 writes and stage A reads the filtered
// planes (4 * ((A-1)*sps + T) * C bytes each way, 37 MB at config 3's 1024
// x 512 block) and the FIR does 4 * ntaps operations a filtered row and
// channel (1.2 GFLOP at 65 taps): stage 0 alone is bound about equally by
// its bytes (raw in, filtered out: 74 MB float32, 55 MB int16) and by the
// float32 rate of its fused multiply-adds.  Its inner loop is 93% fused
// multiply-adds, yet on an H100 they run at about half the float32 rate
// (about 0.038 ms for config 3's block with only the first tile staged and
// nothing stored, against 0.018 at the full rate), and its copies (about
// 0.031 ms alone) hide only in part under them (tools/fir_bounds.py).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <utility>

#include "timing.cuh"

namespace {

constexpr int kTrend = 9;               // UNWRAP_TREND_LEN
constexpr int kTrend1 = kTrend - 1;
constexpr float kTwoPi = 6.2831853071795865f;
constexpr float kQuarterPi = 0.7853981633974483f;
constexpr int kGroup = 8;               // channels per stage-B block
constexpr int kSymsPerWarp = 32 / kGroup;
constexpr int kMaxThreads = 1024;
constexpr float kHalfInvPi = 0.15915494309189535f;   // 1 / (2 pi)
constexpr int kFirChannels = 32;        // stage 0: channels a block
constexpr int kFirRowsPer = 16;         // ... outputs a thread
constexpr int kFirGroup = 8;            // ... taps a group
constexpr int kFirMaxRowThreads = 8;    // ... threads a channel, at most
constexpr int kFirMinBlocks = 2;        // ... blocks an SM holds
// Groups a turn of the register window, and its slots a plane: the
// fewest whole groups that hold a group's kFirRowsPer + kFirGroup - 1
// samples.
constexpr int kFirPhases = (kFirRowsPer + 2 * kFirGroup - 2) / kFirGroup;
constexpr int kFirSlots = kFirPhases * kFirGroup;
static_assert(kFirGroup % 4 == 0, "taps are read as float4s");

__device__ __forceinline__ float mth_phase(float re, float im, int m) {
  float zr = re, zi = im;
  for (int mm = m; mm > 1; mm >>= 1) {
    const float nr = zr * zr - zi * zi;
    const float ni = 2.f * zr * zi;
    zr = nr;
    zi = ni;
  }
  return atan2f(zi, zr);
}

__device__ __forceinline__ void store_code(void* plane, int pack,
                                           int64_t i, int v) {
  if (pack)
    static_cast<int8_t*>(plane)[i] = (int8_t)v;
  else
    static_cast<int32_t*>(plane)[i] = v;
}

struct Params {
  psk::PlanesT<float> in;     // float32 planes, or the filtered scratch
  psk::PlanesT<int16_t> in16;  // int16 planes (i16 set, no matched filter)
  int i16;
  psk::InterpTable itab;  // timing_interp: per-bin cos, sin; sps / 2pi
  float* sel_re;          // (S, C) scratch: decision samples
  float* sel_im;
  float* raw;             // (S, C) scratch: atan2 of the M-th power
  int* first_bad;         // (2, sps, C): first NaN / +inf energy symbol
  const float* state_in;
  float* state_out;
  const float* fir_w;     // phase_avg endpoint-fit weights, oldest first
  void* soft_re;          // (S, C) float32, or int8 when soft_i8
  void* soft_im;
  float* phase;           // (S, C) float32, or null (debug ports off)
  void* bits;             // (S, C) int8 when pack_out, else int32
  void* idx;              // (S, C) like bits, or null (debug ports off)
  int C, S, sps, num_avg, n1, misc, m, diff, pack_out, soft_i8, state_rows;
  int interp, mixed;
  int group, tchunk, vec;  // stage A's plan (timing.cuh)
  int chunk;               // stage B: symbols a chunk
  float soft_scale;
  float m_scale;          // m / (2 pi), rounded once to float
};

// Stage A/B's stream: sample r of channel c, dequantized.
__device__ __forceinline__ void stream_sample(const Params& p, int64_t r,
                                              int c, float& re, float& im) {
  if (p.i16)
    p.in16.sample(r, c, re, im);
  else
    p.in.sample(r, c, re, im);
}

// A channel's constellation: M (as the carry holds it), the power its
// squarings reach, QPSK and BPSK flags, differential decoding.  Static
// unless mixed, when rows misc+6 and misc+7 hold them (the Pallas
// kernel's selects: powers 2, 4, 8, 16, else 32; differential above 0.5).
struct Lane {
  float mf;
  int pw;
  bool is2, is4, diff;
};

__device__ __forceinline__ Lane lane_mode(const Params& p, int c) {
  if (!p.mixed)
    return Lane{(float)p.m, p.m, p.m == 2, p.m == 4, p.diff != 0};
  const float mf = p.state_in[(int64_t)(p.misc + 6) * p.C + c];
  const float df = p.state_in[(int64_t)(p.misc + 7) * p.C + c];
  const int pw = mf == 2.f ? 2 : mf == 4.f ? 4 : mf == 8.f ? 8
               : mf == 16.f ? 16 : 32;
  return Lane{mf, pw, mf == 2.f, mf == 4.f, df > 0.5f};
}

// ---- stage 0 (matched filter) ----

// Floats of the taps in shared memory, a whole number of float4s.
__host__ __device__ __forceinline__ int fir_tap_floats(int ntaps) {
  return (ntaps + 3) / 4 * 4;
}

// Dynamic shared memory of a stage-0 block: the taps, then `stages`
// buffers of a tile's raw rows (tile + ntaps - 1 rows of 32 channels, re
// then im) of `esize`-byte samples.
__host__ __device__ __forceinline__ int64_t fir_smem_bytes(int ntaps,
                                                           int tile,
                                                           int stages,
                                                           int esize) {
  return 4 * (int64_t)fir_tap_floats(ntaps)
         + (int64_t)stages * 2 * (tile + ntaps - 1) * kFirChannels * esize;
}

// One group of kFirGroup taps from j0 (group g = j0 / kFirGroup, kPhase =
// g % kFirPhases) for a thread's kFirRowsPer outputs.  Raw sample s (rows
// from the thread's first row) lives in window slot s % kFirSlots: the
// group's new samples s = j0 + kFirRowsPer - 1 .. + kFirGroup replace
// samples s - kFirSlots < j0, which no later tap needs; then every output
// takes the group's taps in order.
template <int kPhase, class T>
__device__ __forceinline__ void fir_group(const T* sre, const T* sim,
                                          const float* taps, int j0,
                                          float scale,
                                          float (&wr)[kFirSlots],
                                          float (&wi)[kFirSlots],
                                          float (&ar)[kFirRowsPer],
                                          float (&ai)[kFirRowsPer]) {
  constexpr int kBase = kPhase * kFirGroup;
#pragma unroll
  for (int k = 0; k < kFirGroup; ++k) {
    const int s = j0 + kFirRowsPer - 1 + k;
    wr[(kBase + kFirRowsPer - 1 + k) % kFirSlots] =
        psk::dequant(sre[s * kFirChannels], scale);
    wi[(kBase + kFirRowsPer - 1 + k) % kFirSlots] =
        psk::dequant(sim[s * kFirChannels], scale);
  }
  float tv[kFirGroup];
#pragma unroll
  for (int k = 0; k < kFirGroup; k += 4) {
    const float4 t4 = *reinterpret_cast<const float4*>(taps + j0 + k);
    tv[k] = t4.x;
    tv[k + 1] = t4.y;
    tv[k + 2] = t4.z;
    tv[k + 3] = t4.w;
  }
#pragma unroll
  for (int k = 0; k < kFirGroup; ++k)
#pragma unroll
    for (int i = 0; i < kFirRowsPer; ++i) {
      ar[i] = fmaf(tv[k], wr[(kBase + i + k) % kFirSlots], ar[i]);
      ai[i] = fmaf(tv[k], wi[(kBase + i + k) % kFirSlots], ai[i]);
    }
}

// Groups g + P, P in kP..., in order (each only where g + P < ng unless
// kAll): one turn of the window, or what is left of the last one.
template <bool kAll, class T, int... kP>
__device__ __forceinline__ void fir_groups(std::integer_sequence<int, kP...>,
                                           int g, int ng, const T* sre,
                                           const T* sim, const float* taps,
                                           float scale,
                                           float (&wr)[kFirSlots],
                                           float (&wi)[kFirSlots],
                                           float (&ar)[kFirRowsPer],
                                           float (&ai)[kFirRowsPer]) {
  ((kAll || g + kP < ng
        ? fir_group<kP>(sre, sim, taps, (g + kP) * kFirGroup, scale, wr, wi,
                        ar, ai)
        : void()),
   ...);
}

// Blocks: x a run of `run_rows` filtered rows, y a strip of 32 channels;
// 32 * row_threads threads, lane = channel; two staging buffers, one where
// a run is one tile.  rows_f filtered rows of rows_f + ntaps - 1 raw ones.
template <class T>
__global__ void __launch_bounds__(kFirChannels * kFirMaxRowThreads,
                                  kFirMinBlocks)
demod_fir_kernel(const __grid_constant__ psk::PlanesT<T> raw, int64_t rows_f,
                 const float* taps, int ntaps, int run_rows, int vec,
                 float* out_re, float* out_im) {
  extern __shared__ __align__(16) float fsm[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = kFirRowsPer * (nt / kFirChannels);
  const int span = tile + ntaps - 1;        // raw rows a tile reads
  const int plane = span * kFirChannels;    // samples of one staged plane
  float* const s_t = fsm;
  T* const bufs = reinterpret_cast<T*>(fsm + fir_tap_floats(ntaps));
  const int lane = tid % kFirChannels;
  const int rg = tid / kFirChannels;
  const int c0 = blockIdx.y * kFirChannels;
  const int c = c0 + lane;
  const int64_t run0 = (int64_t)blockIdx.x * run_rows;
  const int64_t run_end = run0 + run_rows < rows_f ? run0 + run_rows : rows_f;
  const int ntiles = (int)((run_end - run0 + tile - 1) / tile);
  const int64_t rows_raw = rows_f + ntaps - 1;
  // Staging: thread tid copies `vec` bytes of column q of rows tid >> lg,
  // + rstep, ... (a row of the strip is cpr = 2^lg copies).
  const int per = vec / (int)sizeof(T);     // channels a copy
  const int lg = __ffs(kFirChannels / per) - 1;
  const int q = tid & ((1 << lg) - 1);
  const int rstep = nt >> lg;
  const int col = c0 + q * per;
  const bool col_ok = col < raw.C;

  // Raw rows r0 + first .. + n of both planes into buffer rows first ..;
  // rows past the stream and channels past C read as 0.
  auto stage = [&](T* buf, int64_t r0, int first, int n) {
    for (int ri = first + (tid >> lg); ri < first + n; ri += rstep) {
      const int64_t r = r0 + ri;
      const bool ok = col_ok && r < rows_raw;
      T* const dst = buf + ri * kFirChannels + q * per;
      psk::timing_cp_async(dst, ok ? raw.row(r, false) + col : raw.x_re, vec,
                           ok ? vec : 0);
      psk::timing_cp_async(dst + plane, ok ? raw.row(r, true) + col
                                           : raw.x_re, vec, ok ? vec : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto buf = [&](int t) { return bufs + (t & 1) * 2 * plane; };

  for (int i = tid; i < ntaps; i += nt) s_t[i] = taps[i];
  stage(bufs, run0, 0, span);
  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // tile t staged; the readers of tile t-1 done
    T* const cur = buf(t);
    const int64_t r0 = run0 + (int64_t)t * tile;
    if (t + 1 < ntiles) {
      // Tile t+1: its new rows by cp.async, the ntaps - 1 rows it shares
      // with tile t copied across in shared memory, 16 bytes a copy.
      stage(buf(t + 1), r0 + tile, ntaps - 1, tile);
      const int nv = (ntaps - 1) * kFirChannels * (int)sizeof(T) / 16;
      const uint4* const from = reinterpret_cast<const uint4*>(
          cur + tile * kFirChannels);
      uint4* const to = reinterpret_cast<uint4*>(buf(t + 1));
      const int pv = plane * (int)sizeof(T) / 16;   // uint4s a plane
      for (int v = tid; v < nv; v += nt) {
        to[v] = from[v];
        to[pv + v] = from[pv + v];
      }
    }

    const int64_t row0 = r0 + rg * kFirRowsPer;
    if (row0 >= run_end || c >= raw.C) continue;
    const T* const sre = cur + rg * kFirRowsPer * kFirChannels + lane;
    const T* const sim = sre + plane;
    float ar[kFirRowsPer], ai[kFirRowsPer], wr[kFirSlots], wi[kFirSlots];
#pragma unroll
    for (int i = 0; i < kFirRowsPer; ++i) ar[i] = ai[i] = 0.f;
#pragma unroll
    for (int s = 0; s + 1 < kFirRowsPer; ++s) {
      wr[s] = psk::dequant(sre[s * kFirChannels], raw.scale);
      wi[s] = psk::dequant(sim[s * kFirChannels], raw.scale);
    }
    const int ng = ntaps / kFirGroup;
    int g = 0;
    for (; g + kFirPhases <= ng; g += kFirPhases)
      fir_groups<true>(std::make_integer_sequence<int, kFirPhases>(), g, ng,
                       sre, sim, s_t, raw.scale, wr, wi, ar, ai);
    fir_groups<false>(std::make_integer_sequence<int, kFirPhases - 1>(), g,
                      ng, sre, sim, s_t, raw.scale, wr, wi, ar, ai);
    for (int j = ng * kFirGroup; j < ntaps; ++j) {   // the last taps
      const float tj = s_t[j];
#pragma unroll
      for (int i = 0; i < kFirRowsPer; ++i) {
        ar[i] = fmaf(tj, psk::dequant(sre[(i + j) * kFirChannels], raw.scale),
                     ar[i]);
        ai[i] = fmaf(tj, psk::dequant(sim[(i + j) * kFirChannels], raw.scale),
                     ai[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFirRowsPer; ++i) {
      if (row0 + i < run_end) {
        out_re[(row0 + i) * raw.C + c] = ar[i];
        out_im[(row0 + i) * raw.C + c] = ai[i];
      }
    }
  }
}

// ---- stage A ----

struct TimingEmit {
  const Params& p;
  __device__ __forceinline__ void operator()(int o, int c, int b, float re,
                                             float im) const {
    const int64_t i = (int64_t)o * p.C + c;
    p.sel_re[i] = re;
    p.sel_im[i] = im;
    p.raw[i] = mth_phase(re, im, lane_mode(p, c).pw);
    if (p.idx) store_code(p.idx, p.pack_out, i, b);
  }
};

struct NoteNonFinite {
  const Params& p;
  __device__ __forceinline__ void operator()(float e, int t, int j,
                                             int c) const {
    if (!(e <= FLT_MAX)) {              // NaN or +inf (energy is >= 0)
      const int kind = e != e ? 0 : 1;
      atomicMin(p.first_bad + ((int64_t)kind * p.sps + j) * p.C + c, t);
    }
  }
};

template <class T, bool kInterp>
__global__ void __launch_bounds__(psk::kTimingThreads)
demod_timing_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (sizeof(T) == sizeof(int16_t))
    psk::timing_block<kInterp>(p.in16, p.S, p.sps, p.num_avg, p.group,
                               p.tchunk, p.vec, smem, TimingEmit{p},
                               NoteNonFinite{p}, p.itab);
  else
    psk::timing_block<kInterp>(p.in, p.S, p.sps, p.num_avg, p.group,
                               p.tchunk, p.vec, smem, TimingEmit{p},
                               NoteNonFinite{p}, p.itab);
}

// ---- stage B ----

// The plain version's rule for a channel whose window has reached a
// non-finite sample: bin j's sum at output symbol o is NaN once the
// window's newest symbol reaches a NaN (o + num_avg - 1 >= tn) or an inf
// has left it (o > ti), inf while it holds an inf, else finite.  The first
// NaN bin, else the first inf bin, is the maximum; with neither, stage A's
// pick stands.  On a change, re-gather the sample and its raw phase.
// (Not under timing_interp, whose pick is no bin's: stage A's carried sums
// already give the plain rule.)
__device__ void apply_nonfinite_rule(const Params& p, int o, int c, int pw,
                                     float& sre, float& sim, float& raw) {
  const int hi = o + p.num_avg - 1;
  int b = -1;
  for (int j = 0; j < p.sps; ++j) {
    const int tn = p.first_bad[(int64_t)j * p.C + c];
    const int ti = p.first_bad[((int64_t)p.sps + j) * p.C + c];
    if (hi >= tn || o > ti) { b = j; break; }
    if (b < 0 && hi >= ti) b = j + p.sps;   // first inf bin, kept unless NaN
  }
  if (b < 0) return;
  if (b >= p.sps) b -= p.sps;
  stream_sample(p, (int64_t)o * p.sps + b, c, sre, sim);
  raw = mth_phase(sre, sim, pw);
  if (p.idx) store_code(p.idx, p.pack_out, (int64_t)o * p.C + c, b);
}

// Floats of one history buffer: rows of kGroup channels each, for u
// (n1 + chunk), trend cos and sin (8 + chunk each), ang_t, decision re
// and im (1 + chunk each).  Row h + k holds symbol base + k of a chunk;
// rows below h are the history before it.
__host__ __device__ __forceinline__ int track_buffer_floats(int n1,
                                                            int chunk) {
  return ((n1 + chunk) + 2 * (kTrend1 + chunk) + 3 * (1 + chunk)) * kGroup;
}

__host__ __device__ __forceinline__ int64_t track_smem_bytes(int n1,
                                                             int chunk) {
  return (int64_t)sizeof(float)
         * (2 * track_buffer_floats(n1, chunk) + (n1 + 1)
            + (chunk / kSymsPerWarp) * kGroup + 3 * kGroup);
}

__global__ void __launch_bounds__(kMaxThreads)
demod_track_kernel(const __grid_constant__ Params p) {
  extern __shared__ float sm[];
  const int K = p.chunk;
  const int n1 = p.n1;
  const int C = p.C;
  const int nt = blockDim.x;            // K * kGroup
  const int tid = threadIdx.x;
  const int g = tid % kGroup;           // channel within the group
  const int k = tid / kGroup;           // symbol within the chunk
  const int c0 = blockIdx.x * kGroup;
  const int c = c0 + g;
  const bool live = c < C;
  const int misc = p.misc;
  const Lane mode = lane_mode(p, live ? c : c0);

  // Shared memory: two history buffers, the FIR weights, the scan's warp
  // totals, and per channel the running wrap count, unwrap_acc and the
  // first non-finite symbol.
  const int bsz = track_buffer_floats(n1, K);
  const int offCR = (n1 + K) * kGroup;
  const int offCI = offCR + (kTrend1 + K) * kGroup;
  const int offA = offCI + (kTrend1 + K) * kGroup;
  const int offPR = offA + (1 + K) * kGroup;
  const int offPI = offPR + (1 + K) * kGroup;
  float* const bufs = sm;
  float* const w = sm + 2 * bsz;
  float* const tot = w + n1 + 1;
  float* const cum_base = tot + (K / kSymsPerWarp) * kGroup;
  float* const acc = cum_base + kGroup;
  int* const first = reinterpret_cast<int*>(acc + kGroup);

  // --- carries in: histories of buffer 0, weights, first bad symbol ---
  for (int i = tid; i <= n1; i += nt) w[i] = p.fir_w[i];
  auto carry = [&](int r, int gg) {
    return c0 + gg < C ? p.state_in[(int64_t)r * C + c0 + gg] : 0.f;
  };
  for (int i = tid; i < n1 * kGroup; i += nt)
    bufs[i] = carry(i / kGroup, i % kGroup);
  for (int i = tid; i < kTrend1 * kGroup; i += nt) {
    bufs[offCR + i] = carry(n1 + i / kGroup, i % kGroup);
    bufs[offCI + i] = carry(n1 + kTrend1 + i / kGroup, i % kGroup);
  }
  if (tid < kGroup) {
    bufs[offA + tid] = carry(misc, tid);
    bufs[offPR + tid] = carry(misc + 2, tid);
    bufs[offPI + tid] = carry(misc + 3, tid);
    acc[tid] = carry(misc + 1, tid);
    cum_base[tid] = 0.f;
    first[tid] = INT32_MAX;
  }
  __syncthreads();
  for (int i = tid; i < 2 * p.sps * kGroup; i += nt) {
    const int gg = i % kGroup;
    if (c0 + gg < C)
      atomicMin(first + gg, p.first_bad[(int64_t)(i / kGroup) * C + c0 + gg]);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  int cur = 0;
  for (int base = 0; base < p.S; base += K) {
    const int nk = min(K, p.S - base);
    float* const B = bufs + cur * bsz;
    float* const N = bufs + (cur ^ 1) * bsz;
    const int o = base + k;
    const bool act = live && k < nk;

    // 1. Stage A's terms; the non-finite rule where the window has
    // reached a non-finite sample.
    float sre = 0.f, sim = 0.f, raw = 0.f;
    if (act) {
      const int64_t i = (int64_t)o * C + c;
      sre = p.sel_re[i];
      sim = p.sel_im[i];
      raw = p.raw[i];
      if (!p.interp && o + p.num_avg - 1 >= first[g])
        apply_nonfinite_rule(p, o, c, mode.pw, sre, sim, raw);
    }
    float c_re, c_im;
    sincosf(raw, &c_im, &c_re);
    B[offCR + (kTrend1 + k) * kGroup + g] = c_re;
    B[offCI + (kTrend1 + k) * kGroup + g] = c_im;
    B[offPR + (1 + k) * kGroup + g] = sre;
    B[offPI + (1 + k) * kGroup + g] = sim;
    __syncthreads();

    // 2. Trend: the 8 previous cos/sin (oldest first), then the current.
    float t_re = 0.f, t_im = 0.f;
#pragma unroll
    for (int i = 0; i < kTrend1; ++i) {
      t_re += B[offCR + (k + i) * kGroup + g];
      t_im += B[offCI + (k + i) * kGroup + g];
    }
    t_re += c_re;
    t_im += c_im;
    const float ang_t = atan2f(t_im, t_re);
    B[offA + (1 + k) * kGroup + g] = ang_t;
    __syncthreads();

    // 3. Wrap counts (round half to even, like torch.round) and their
    // prefix sum: shuffles across the warp's symbols, then the totals of
    // the earlier warps and of the earlier chunks.
    float v = k < nk ? rintf((ang_t - B[offA + k * kGroup + g]) / kTwoPi)
                     : 0.f;
#pragma unroll
    for (int off = kGroup; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane >= 32 - kGroup) tot[warp * kGroup + g] = v;
    __syncthreads();
    float cum = cum_base[g];
    for (int q = 0; q < warp; ++q) cum += tot[q * kGroup + g];
    cum += v;
    const float t_unw = ang_t + acc[g] - kTwoPi * cum;
    const float resid = raw - ang_t;
    const float u = t_unw + (resid - kTwoPi * rintf(resid / kTwoPi));
    B[(n1 + k) * kGroup + g] = u;
    __syncthreads();

    // 4. Endpoint-fit FIR over [u history | u], derotation or the
    // differential decode, slicing, outputs.
    if (act) {
      float est = 0.f;
      const float* uh = B + k * kGroup + g;
      for (int i = 0; i < n1; ++i) est += w[i] * uh[i * kGroup];
      est += w[n1] * u;

      float base_r, base_i, corr;
      if (mode.diff) {
        const float prev_re = B[offPR + k * kGroup + g];
        const float prev_im = B[offPI + k * kGroup + g];
        const float pp = prev_re * prev_re + prev_im * prev_im;
        const float inv = 1.f / (pp == 0.f ? 1.f : pp);
        base_r = (sre * prev_re + sim * prev_im) * inv;
        base_i = (sim * prev_re - sre * prev_im) * inv;
        corr = 0.f;
      } else {
        base_r = sre;
        base_i = sim;
        corr = -est / mode.mf;
      }
      if (mode.is4) corr += kQuarterPi;
      float cph_r, cph_i;
      sincosf(corr, &cph_i, &cph_r);
      const float s_r = base_r * cph_r - base_i * cph_i;
      const float s_i = base_r * cph_i + base_i * cph_r;

      int code;
      if (mode.is2) {
        code = s_r < 0.f;
      } else if (mode.is4) {
        const int sr = s_r < 0.f, si = s_i < 0.f;
        code = (sr ^ si) + 2 * si;
      } else if (!p.mixed) {
        float ss = atan2f(s_i, s_r) * p.m_scale;
        if (ss < -0.5f) ss += (float)p.m;
        code = (int)floorf(ss + 0.5f) & (p.m - 1);
      } else {                  // the lane's M: wrap M down to 0
        float ss = atan2f(s_i, s_r) * (mode.mf * kHalfInvPi);
        if (ss < -0.5f) ss += mode.mf;
        code = (int)floorf(ss + 0.5f);
        if (code >= (int)mode.mf) code -= (int)mode.mf;
      }

      const int64_t out = (int64_t)o * C + c;
      if (p.soft_i8) {
        const float qr = fminf(fmaxf(rintf(s_r * p.soft_scale), -127.f),
                               127.f);
        const float qi = fminf(fmaxf(rintf(s_i * p.soft_scale), -127.f),
                               127.f);
        static_cast<int8_t*>(p.soft_re)[out] = (int8_t)qr;
        static_cast<int8_t*>(p.soft_im)[out] = (int8_t)qi;
      } else {
        static_cast<float*>(p.soft_re)[out] = s_r;
        static_cast<float*>(p.soft_im)[out] = s_i;
      }
      if (p.phase) p.phase[out] = est;
      store_code(p.bits, p.pack_out, out, code);
    }

    // 5. The histories the next chunk starts from go to the other buffer.
    const int shift = nk * kGroup;
    for (int i = tid; i < n1 * kGroup; i += nt) N[i] = B[i + shift];
    for (int i = tid; i < kTrend1 * kGroup; i += nt) {
      N[offCR + i] = B[offCR + i + shift];
      N[offCI + i] = B[offCI + i + shift];
    }
    if (tid < kGroup) {
      N[offA + tid] = B[offA + shift + tid];
      N[offPR + tid] = B[offPR + shift + tid];
      N[offPI + tid] = B[offPI + shift + tid];
    }
    if (k == nk - 1) cum_base[g] = cum;
    cur ^= 1;
  }
  __syncthreads();

  // --- carries out, with the M*2pi re-wrap from the last unwrapped phase ---
  const float* const F = bufs + cur * bsz;
  for (int i = tid; i < p.state_rows * kGroup; i += nt) {
    const int r = i / kGroup, gg = i % kGroup;
    if (c0 + gg >= C) continue;
    const float wrapv = kTwoPi * lane_mode(p, c0 + gg).mf;
    const float u_last = F[(n1 - 1) * kGroup + gg];
    const float wraps = rintf(u_last / wrapv);
    const float off = fabsf(u_last) > wrapv ? wraps * wrapv : 0.f;
    float val;
    if (r < n1)
      val = F[r * kGroup + gg] - off;
    else if (r < n1 + kTrend1)
      val = F[offCR + (r - n1) * kGroup + gg];
    else if (r < misc)
      val = F[offCI + (r - n1 - kTrend1) * kGroup + gg];
    else if (r == misc)
      val = F[offA + gg];
    else if (r == misc + 1)
      val = acc[gg] - kTwoPi * cum_base[gg] - off;
    else if (r == misc + 2)
      val = F[offPR + gg];
    else if (r == misc + 3)
      val = F[offPI + gg];
    else if (p.interp && (r == misc + 4 || r == misc + 5)) {
      float lre, lim;             // row S-1's last sample
      stream_sample(p, (int64_t)p.S * p.sps - 1, c0 + gg, lre, lim);
      val = r == misc + 4 ? lre : lim;
    } else
      val = p.state_in[(int64_t)r * C + c0 + gg];
    p.state_out[(int64_t)r * C + c0 + gg] = val;
  }
}

cudaError_t allow_smem(const void* kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <class T, bool kInterp>
cudaError_t launch_timing(const Params& p, int64_t smem, cudaStream_t s) {
  const cudaError_t e =
      allow_smem((const void*)demod_timing_kernel<T, kInterp>, smem);
  if (e != cudaSuccess) return e;
  demod_timing_kernel<T, kInterp>
      <<<(p.C + p.group - 1) / p.group, psk::kTimingThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// 0 when (rows_per_thread, tap_group, row_threads, run_rows, stages, vec)
// is a plan demod_fir_kernel was built for and takes for these planes
// (ops/cuda/demod_kernel.fir_plan makes it): its own outputs a thread and
// taps a group; 1, 2, 4 or 8 row threads; runs a whole number of tiles;
// 2 buffers, or 1 for runs of one tile; copies of 16, 8, 4 (or, int16, 2)
// bytes that fit a strip, the row stride and the planes' addresses.
template <class T>
int fir_plan_error(const psk::PlanesT<T>& raw, int64_t rows_f, int ntaps,
                   int rows_per_thread, int tap_group, int row_threads,
                   int run_rows, int stages, int vec) {
  const int es = (int)sizeof(T);
  if (rows_per_thread != kFirRowsPer || tap_group != kFirGroup
      || rows_f < 1 || ntaps < 1 || raw.C < 1 || row_threads < 1
      || row_threads > kFirMaxRowThreads || (row_threads & (row_threads - 1))
      || run_rows < 1 || run_rows % (kFirRowsPer * row_threads)
      || stages < 1 || stages > 2
      || (stages == 1 && run_rows != kFirRowsPer * row_threads)
      || (vec != 16 && vec != 8 && vec != 4 && vec != es)
      || (kFirChannels * es) % vec || ((int64_t)es * raw.C) % vec
      || (rows_f + run_rows - 1) / run_rows > INT32_MAX
      || (raw.C + kFirChannels - 1) / kFirChannels > 65535)
    return 1;
  const T* ptrs[4] = {raw.win_re, raw.win_im, raw.x_re, raw.x_im};
  for (int i = raw.win_rows ? 0 : 2; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % vec) return 1;
  return 0;
}

template <class T>
cudaError_t launch_fir(const psk::PlanesT<T>& raw, int64_t rows_f,
                       const float* taps, int ntaps, int rows_per_thread,
                       int tap_group, int row_threads, int run_rows,
                       int stages, int vec, float* out_re, float* out_im,
                       cudaStream_t s) {
  if (fir_plan_error(raw, rows_f, ntaps, rows_per_thread, tap_group,
                     row_threads, run_rows, stages, vec))
    return cudaErrorInvalidValue;
  const int64_t smem = fir_smem_bytes(ntaps, kFirRowsPer * row_threads,
                                      stages, (int)sizeof(T));
  const cudaError_t e = allow_smem((const void*)demod_fir_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((rows_f + run_rows - 1) / run_rows),
                  (unsigned)((raw.C + kFirChannels - 1) / kFirChannels));
  demod_fir_kernel<T><<<grid, kFirChannels * row_threads, smem, s>>>(
      raw, rows_f, taps, ntaps, run_rows, vec, out_re, out_im);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory per block of stage A (stage 0: sps, its group and
// chunk, the element size of the planes it reads, interp), stage B (stage
// 1: phase_avg and its chunk) or the matched filter's stage 0 (stage 2:
// its taps, its tile rows as `chunk`, its buffers as `group`, the element
// size of the raw planes), so the wrapper's launch plan can be checked
// against it.
extern "C" int64_t psk_demod_full_smem(int stage, int sps, int phase_avg,
                                       int chunk, int group, int esize,
                                       int interp, int ntaps) {
  if (stage == 0)
    return psk::timing_smem_bytes(sps, group, chunk, esize, interp);
  return stage == 1 ? track_smem_bytes(phase_avg - 1, chunk)
                    : fir_smem_bytes(ntaps, chunk, group, esize);
}

// The matched filter alone (stage 0): (rows_raw, C) raw planes, float32 or
// int16 (dequantized as v * in_scale), into (rows_raw - ntaps + 1, C)
// float32 out_re and out_im, on `stream`, with the plan of
// ops/cuda/demod_kernel.fir_plan.  Returns 0 once launched,
// cudaErrorInvalidValue for arguments or a plan the kernel does not take,
// or the launch's error.
extern "C" int psk_matched_filter_tm(
    const void* raw_re, const void* raw_im, int64_t rows_raw, int C, int i16,
    float in_scale, const float* taps, int ntaps, float* out_re,
    float* out_im, int rows_per_thread, int tap_group, int row_threads,
    int run_rows, int stages, int vec, void* stream) {
  if (ntaps < 1 || rows_raw < ntaps || !taps || !out_re || !out_im)
    return (int)cudaErrorInvalidValue;
  const int64_t rows_f = rows_raw - ntaps + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i16) {
    const psk::PlanesT<int16_t> raw{
        static_cast<const int16_t*>(raw_re),
        static_cast<const int16_t*>(raw_im),
        static_cast<const int16_t*>(raw_re),
        static_cast<const int16_t*>(raw_im), 0, C, in_scale};
    return (int)launch_fir(raw, rows_f, taps, ntaps, rows_per_thread,
                           tap_group, row_threads, run_rows, stages, vec,
                           out_re, out_im, s);
  }
  const psk::PlanesT<float> raw{static_cast<const float*>(raw_re),
                                static_cast<const float*>(raw_im),
                                static_cast<const float*>(raw_re),
                                static_cast<const float*>(raw_im), 0, C};
  return (int)launch_fir(raw, rows_f, taps, ntaps, rows_per_thread,
                         tap_group, row_threads, run_rows, stages, vec,
                         out_re, out_im, s);
}

// Launch on `stream`: with a matched filter (ntaps > 0) stage 0, then a
// memset of first_bad, stage A, stage B.  Pointers are device pointers;
// the planes are float32, or int16 when i16 (dequantized as v * in_scale);
// phase and idx may be null; sel_re, sel_im, raw ((S, C) float32),
// first_bad ((2, sps, C) int32) and, with a matched filter, filt_re and
// filt_im (((num_avg-1)*sps + S*sps, C) float32) are scratch.  The window
// holds (num_avg-1)*sps + ntaps-1 rows (raw samples under a filter).
// interp_tab (timing_interp) holds cos then sin of j * 2pi / sps, j < sps.
// fir_* is stage 0's plan (ops/cuda/demod_kernel.fir_plan), read only
// under a filter.  Returns 0 once all are launched, cudaErrorInvalidValue
// for arguments the kernels do not take, or the first error of a launch
// (cudaGetLastError()).
extern "C" int psk_demod_full_tm(
    const void* win_re, const void* win_im, int64_t win_rows,
    const void* x_re, const void* x_im, const float* state_in,
    float* state_out, const float* fir_w, void* soft_re, void* soft_im,
    float* phase, void* bits, void* idx, float* sel_re, float* sel_im,
    float* raw, int* first_bad, int C, int S, int sps, int num_avg,
    int phase_avg, int m, int diff, int pack_out, int soft_i8,
    float soft_scale, int state_rows, int group, int tchunk, int vec,
    int chunk, int i16, float in_scale, int interp,
    const float* interp_tab, int mixed, const float* mf_taps, int ntaps,
    float* filt_re, float* filt_im, int fir_rows_per_thread,
    int fir_tap_group, int fir_row_threads, int fir_run_rows,
    int fir_stages, int fir_vec, void* stream) {
  const int64_t wrows = (int64_t)(num_avg - 1) * sps;
  const int extra = ntaps > 0 ? ntaps - 1 : 0;
  const int misc = phase_avg - 1 + 2 * kTrend1;
  if (C < 1 || S < 1 || sps < 2 || num_avg < 2 || phase_avg < kTrend + 1
      || chunk < kSymsPerWarp || chunk % kSymsPerWarp
      || chunk * kGroup > kMaxThreads || win_rows != wrows + extra
      || ntaps < 0 || (ntaps && (!mf_taps || !filt_re || !filt_im))
      || (interp && !interp_tab) || state_rows < misc + 8)
    return (int)cudaErrorInvalidValue;
  // The raw planes as they arrive (stage 0's input under a filter).
  const psk::PlanesT<float> raw_f{
      static_cast<const float*>(win_re), static_cast<const float*>(win_im),
      static_cast<const float*>(x_re), static_cast<const float*>(x_im),
      win_rows, C};
  const psk::PlanesT<int16_t> raw_i{
      static_cast<const int16_t*>(win_re),
      static_cast<const int16_t*>(win_im),
      static_cast<const int16_t*>(x_re), static_cast<const int16_t*>(x_im),
      win_rows, C, in_scale};
  Params p;
  const int64_t rows_f = wrows + (int64_t)S * sps;
  if (ntaps) {                  // stages A and B read the filtered stream
    p.in = psk::PlanesT<float>{filt_re, filt_im, filt_re + wrows * C,
                               filt_im + wrows * C, wrows, C};
    p.i16 = 0;
  } else {
    p.in = raw_f;
    p.in16 = raw_i;
    p.i16 = i16 != 0;
  }
  if (p.i16 ? psk::timing_plan_error(p.in16, sps, group, tchunk, vec)
            : psk::timing_plan_error(p.in, sps, group, tchunk, vec))
    return (int)cudaErrorInvalidValue;
  p.itab = psk::InterpTable{interp_tab, interp_tab ? interp_tab + sps
                                                   : nullptr,
                            (float)((double)sps / 6.283185307179586)};
  p.sel_re = sel_re;
  p.sel_im = sel_im;
  p.raw = raw;
  p.first_bad = first_bad;
  p.state_in = state_in;
  p.state_out = state_out;
  p.fir_w = fir_w;
  p.soft_re = soft_re;
  p.soft_im = soft_im;
  p.phase = phase;
  p.bits = bits;
  p.idx = idx;
  p.C = C;
  p.S = S;
  p.sps = sps;
  p.num_avg = num_avg;
  p.n1 = phase_avg - 1;
  p.misc = misc;
  p.m = m;
  p.diff = diff;
  p.pack_out = pack_out;
  p.soft_i8 = soft_i8;
  p.state_rows = state_rows;
  p.interp = interp != 0;
  p.mixed = mixed != 0;
  p.group = group;
  p.tchunk = tchunk;
  p.vec = vec;
  p.chunk = chunk;
  p.soft_scale = soft_scale;
  p.m_scale = (float)((double)m / 6.283185307179586);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (ntaps) {
    e = i16 ? launch_fir(raw_i, rows_f, mf_taps, ntaps, fir_rows_per_thread,
                         fir_tap_group, fir_row_threads, fir_run_rows,
                         fir_stages, fir_vec, filt_re, filt_im, s)
            : launch_fir(raw_f, rows_f, mf_taps, ntaps, fir_rows_per_thread,
                         fir_tap_group, fir_row_threads, fir_run_rows,
                         fir_stages, fir_vec, filt_re, filt_im, s);
    if (e != cudaSuccess) return (int)e;
  }
  // 0x7f7f7f7f: no non-finite sample seen (above any symbol index).
  e = cudaMemsetAsync(first_bad, 0x7f, sizeof(int) * 2 * (size_t)sps * C, s);
  if (e != cudaSuccess) return (int)e;

  const int64_t smem_a = psk::timing_smem_bytes(
      sps, group, tchunk, p.i16 ? 2 : 4, p.interp);
  if (p.i16)
    e = p.interp ? launch_timing<int16_t, true>(p, smem_a, s)
                 : launch_timing<int16_t, false>(p, smem_a, s);
  else
    e = p.interp ? launch_timing<float, true>(p, smem_a, s)
                 : launch_timing<float, false>(p, smem_a, s);
  if (e != cudaSuccess) return (int)e;

  const int64_t smem_b = track_smem_bytes(p.n1, chunk);
  e = allow_smem((const void*)demod_track_kernel, smem_b);
  if (e != cudaSuccess) return (int)e;
  demod_track_kernel<<<(C + kGroup - 1) / kGroup, chunk * kGroup, smem_b,
                       s>>>(p);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block may use on the current device, so
// the wrapper can reject shapes whose stages would not fit.
extern "C" int psk_demod_full_max_smem(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}
