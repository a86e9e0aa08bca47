// Kernel B1 for Hopper (sm_90a): the fused steady-state PSK demod.
//
// Replaces the Pallas kernel psk_soft_tpu/ops/pallas/demod_kernel.py
// (demod_full_tm, body _kernel).  One pass over a block of time-major
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
//   rows misc+4 .. and pad  passed through unchanged
//
// Design (first version: simple and right).  One thread owns one channel
// and walks the block's S symbols in order, so every sequential carry
// (window sums, trend ring, unwrap accumulator, FIR history, previous
// decision) stays in registers or in the thread's column of shared memory.
// A warp covers 32 neighbouring channels, so each load of one time-major
// row is one coalesced 128-byte segment.  The timing window is read
// through two pointers: row r of [window | block] comes from `win` when
// r < (num_avg-1)*sps and from `x` otherwise, so the rolling-window mode
// is just a view of the previous block's last rows (no concatenation);
// that reader and the first-max rule (NaN counts as the maximum, as in the
// plain version) are shared with kernel B5 through timing.cuh.
// The window sums slide (add the entering symbol's energy, subtract the
// leaving one's, re-read from L2) instead of the Pallas kernel's cumsum
// per time tile.  The phase-history re-wrap happens once, at the end of
// the block, from the last unwrapped phase (u_last).
//
// What bounds it on an H100: the input is 2 * 4 bytes * T * C (33.5 MB per
// 1024 x 512-symbol block at sps 8), about 10 us of HBM time at 3.35 TB/s.
// But one thread per channel gives only C threads (1024: 32 warps on 32 of
// the 132 SMs, one warp per SM), so the kernel is bound by the latency of
// each channel's dependent chain (global loads, atan2f/sincosf, the
// phase_avg-tap FIR), not by bytes.  Parallelising across symbols (a
// per-(symbol, channel) phase for energy, argmax, pick and M-th power,
// then a per-channel scan) is the next step.
//
// Not handled here (the Python wrapper raises before launching): int16
// ingest, fractional timing, an in-kernel matched filter, mixed per-channel
// modes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "timing.cuh"

namespace {

constexpr int kTrend = 9;               // UNWRAP_TREND_LEN
constexpr int kTrend1 = kTrend - 1;
constexpr float kTwoPi = 6.2831853071795865f;
constexpr float kQuarterPi = 0.7853981633974483f;
constexpr int kThreads = 32;            // channels per block (one warp)

struct Params {
  const float* win_re;
  const float* win_im;
  const float* x_re;
  const float* x_im;
  const float* state_in;
  float* state_out;
  const float* fir_w;     // phase_avg endpoint-fit weights, oldest first
  void* soft_re;          // (S, C) float32, or int8 when soft_i8
  void* soft_im;
  float* phase;           // (S, C) float32, or null (debug ports off)
  void* bits;             // (S, C) int8 when pack_out, else int32
  void* idx;              // (S, C) like bits, or null (debug ports off)
  int64_t win_rows;       // (num_avg - 1) * sps
  int C, S, sps, num_avg, phase_avg, m, diff, pack_out, soft_i8;
  int state_rows;
  float soft_scale;
  float m_scale;          // m / (2 pi), rounded once to float
};

__global__ void __launch_bounds__(kThreads)
demod_full_kernel(const Params p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.C) return;
  const int C = p.C;
  const int sps = p.sps;
  const int n1 = p.phase_avg - 1;
  const int misc = n1 + 2 * kTrend1;
  const int64_t wrows = p.win_rows;

  // Per-thread columns of shared memory: window sums W[sps], then the
  // ring of the last n1 unwrapped phases.  Element i of a column sits at
  // [i * blockDim.x + threadIdx.x], so a warp's accesses never conflict.
  extern __shared__ float smem[];
  const int stride = blockDim.x;
  float* wsum = smem + threadIdx.x;
  float* uring = smem + sps * stride + threadIdx.x;

  const psk::TwoPlanes in{p.win_re, p.win_im, p.x_re, p.x_im, wrows, C};
  auto energy = [&](int64_t r) { return in.energy(r, c); };

  // --- carries in ---
  for (int r = 0; r < p.state_rows; ++r)
    p.state_out[r * C + c] = p.state_in[r * C + c];
  for (int i = 0; i < n1; ++i) uring[i * stride] = p.state_in[i * C + c];
  float cre[kTrend1], cim[kTrend1];
#pragma unroll
  for (int i = 0; i < kTrend1; ++i) {
    cre[i] = p.state_in[(n1 + i) * C + c];
    cim[i] = p.state_in[(n1 + kTrend1 + i) * C + c];
  }
  float ang_prev = p.state_in[misc * C + c];
  const float acc = p.state_in[(misc + 1) * C + c];
  float prev_re = p.state_in[(misc + 2) * C + c];
  float prev_im = p.state_in[(misc + 3) * C + c];

  // --- window sums of output symbol 0: symbols [0, num_avg) ---
  for (int j = 0; j < sps; ++j) wsum[j * stride] = 0.f;
  for (int t = 0; t < p.num_avg; ++t)
    for (int j = 0; j < sps; ++j)
      wsum[j * stride] += energy((int64_t)t * sps + j);

  int pos = 0;            // ring slot of the oldest u
  float cum = 0.f;        // unwrap wraps since the block start
  float u = 0.f;
  for (int o = 0; o < p.S; ++o) {
    // C2 timing: slide the window to symbols [o, o + num_avg), first max.
    if (o > 0) {
      const int64_t r_in = (int64_t)(o + p.num_avg - 1) * sps;
      const int64_t r_out = (int64_t)(o - 1) * sps;
      for (int j = 0; j < sps; ++j)
        wsum[j * stride] = wsum[j * stride] + energy(r_in + j)
                           - energy(r_out + j);
    }
    int b = 0;
    float best = wsum[0];
    for (int j = 1; j < sps; ++j) {
      const float v = wsum[j * stride];
      if (psk::takes_max(v, best)) { best = v; b = j; }
    }
    float sel_re, sel_im;
    in.sample((int64_t)o * sps + b, c, sel_re, sel_im);

    // C3: M-th power phase.
    float zr = sel_re, zi = sel_im;
    for (int mm = p.m; mm > 1; mm >>= 1) {
      const float nr = zr * zr - zi * zi;
      const float ni = 2.f * zr * zi;
      zr = nr;
      zi = ni;
    }
    const float raw = atan2f(zi, zr);

    // Trend: complex moving average over the last kTrend raw phases.
    float c_re, c_im;
    sincosf(raw, &c_im, &c_re);
    float t_re = 0.f, t_im = 0.f;
#pragma unroll
    for (int i = 0; i < kTrend1; ++i) { t_re += cre[i]; t_im += cim[i]; }
    t_re += c_re;
    t_im += c_im;
#pragma unroll
    for (int i = 0; i < kTrend1 - 1; ++i) {
      cre[i] = cre[i + 1];
      cim[i] = cim[i + 1];
    }
    cre[kTrend1 - 1] = c_re;
    cim[kTrend1 - 1] = c_im;
    const float ang_t = atan2f(t_im, t_re);

    // Prefix unwrap of the trend (round half to even, like jnp.round),
    // residual re-attached in (-pi, pi].
    cum += rintf((ang_t - ang_prev) / kTwoPi);
    ang_prev = ang_t;
    const float t_unw = ang_t + acc - kTwoPi * cum;
    const float resid = raw - ang_t;
    u = t_unw + (resid - kTwoPi * rintf(resid / kTwoPi));

    // C1: endpoint-fit FIR over [u history | u].
    float est = 0.f;
    int q = pos;
    for (int i = 0; i < n1; ++i) {
      est += p.fir_w[i] * uring[q * stride];
      q = (q + 1 == n1) ? 0 : q + 1;
    }
    est += p.fir_w[n1] * u;
    uring[pos * stride] = u;
    pos = (pos + 1 == n1) ? 0 : pos + 1;

    // C5: derotation or differential decode.
    float base_r, base_i, corr;
    if (p.diff) {
      const float pp = prev_re * prev_re + prev_im * prev_im;
      const float inv = 1.f / (pp == 0.f ? 1.f : pp);
      base_r = (sel_re * prev_re + sel_im * prev_im) * inv;
      base_i = (sel_im * prev_re - sel_re * prev_im) * inv;
      corr = 0.f;
    } else {
      base_r = sel_re;
      base_i = sel_im;
      corr = -est / (float)p.m;
    }
    if (p.m == 4) corr += kQuarterPi;
    prev_re = sel_re;
    prev_im = sel_im;
    float cph_r, cph_i;
    sincosf(corr, &cph_i, &cph_r);
    const float s_r = base_r * cph_r - base_i * cph_i;
    const float s_i = base_r * cph_i + base_i * cph_r;

    // C6: slicing, packed LSB-first.
    int code;
    if (p.m == 2) {
      code = s_r < 0.f;
    } else if (p.m == 4) {
      const int sr = s_r < 0.f, si = s_i < 0.f;
      code = (sr ^ si) + 2 * si;
    } else {
      float ss = atan2f(s_i, s_r) * p.m_scale;
      if (ss < -0.5f) ss += (float)p.m;
      code = (int)floorf(ss + 0.5f) & (p.m - 1);
    }

    const int64_t out = (int64_t)o * C + c;
    if (p.soft_i8) {
      const float qr = fminf(fmaxf(rintf(s_r * p.soft_scale), -127.f), 127.f);
      const float qi = fminf(fmaxf(rintf(s_i * p.soft_scale), -127.f), 127.f);
      static_cast<int8_t*>(p.soft_re)[out] = (int8_t)qr;
      static_cast<int8_t*>(p.soft_im)[out] = (int8_t)qi;
    } else {
      static_cast<float*>(p.soft_re)[out] = s_r;
      static_cast<float*>(p.soft_im)[out] = s_i;
    }
    if (p.phase) p.phase[out] = est;
    if (p.pack_out) {
      static_cast<int8_t*>(p.bits)[out] = (int8_t)code;
      if (p.idx) static_cast<int8_t*>(p.idx)[out] = (int8_t)b;
    } else {
      static_cast<int32_t*>(p.bits)[out] = code;
      if (p.idx) static_cast<int32_t*>(p.idx)[out] = b;
    }
  }

  // --- carries out, with the M*2pi re-wrap from the last unwrapped phase ---
  const float wrapv = kTwoPi * (float)p.m;
  const float wraps = rintf(u / wrapv);
  const float off = fabsf(u) > wrapv ? wraps * wrapv : 0.f;
  int q = pos;
  for (int i = 0; i < n1; ++i) {
    p.state_out[i * C + c] = uring[q * stride] - off;
    q = (q + 1 == n1) ? 0 : q + 1;
  }
#pragma unroll
  for (int i = 0; i < kTrend1; ++i) {
    p.state_out[(n1 + i) * C + c] = cre[i];
    p.state_out[(n1 + kTrend1 + i) * C + c] = cim[i];
  }
  p.state_out[misc * C + c] = ang_prev;
  p.state_out[(misc + 1) * C + c] = acc - kTwoPi * cum - off;
  p.state_out[(misc + 2) * C + c] = prev_re;
  p.state_out[(misc + 3) * C + c] = prev_im;
}

}  // namespace

// Launch on `stream`.  Pointers are device pointers; phase and idx may be
// null.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int psk_demod_full_tm(
    const float* win_re, const float* win_im, int64_t win_rows,
    const float* x_re, const float* x_im, const float* state_in,
    float* state_out, const float* fir_w, void* soft_re, void* soft_im,
    float* phase, void* bits, void* idx, int C, int S, int sps, int num_avg,
    int phase_avg, int m, int diff, int pack_out, int soft_i8,
    float soft_scale, int state_rows, void* stream) {
  Params p;
  p.win_re = win_re;
  p.win_im = win_im;
  p.x_re = x_re;
  p.x_im = x_im;
  p.state_in = state_in;
  p.state_out = state_out;
  p.fir_w = fir_w;
  p.soft_re = soft_re;
  p.soft_im = soft_im;
  p.phase = phase;
  p.bits = bits;
  p.idx = idx;
  p.win_rows = win_rows;
  p.C = C;
  p.S = S;
  p.sps = sps;
  p.num_avg = num_avg;
  p.phase_avg = phase_avg;
  p.m = m;
  p.diff = diff;
  p.pack_out = pack_out;
  p.soft_i8 = soft_i8;
  p.state_rows = state_rows;
  p.soft_scale = soft_scale;
  p.m_scale = (float)((double)m / 6.283185307179586);

  const size_t smem = (size_t)(sps + phase_avg - 1) * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        demod_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + kThreads - 1) / kThreads;
  demod_full_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block may use on the current device, so
// the wrapper can reject sps + phase_avg that would not fit.
extern "C" int psk_demod_full_max_smem(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}
