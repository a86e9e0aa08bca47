// The C2 timing stage shared by kernels B1 (demod_full.cu, its stage A) and
// B5 (frontend.cu): reading row r of the [window | block] planes through
// two pointers, per-sample energy, the first-max rule of the argmax, and
// the block loop that turns a group of channels into per-symbol decisions
// (window sums over num_avg symbols, first-max bin, the decision sample).
//
// The block loop (timing_block).  One block owns `group` consecutive
// channels for the whole block of S output symbols, so window sums carry
// through the block and no rows are re-read as a tile's halo.  For bin j
// of channel c the sum of output symbol o is P_in - P_out, two running
// sums: P_in of the energies of symbols [0, o + num_avg - 1] (entering)
// and P_out of symbols [0, o - 1] (left) -- the plain version's cumsum
// difference cs[o + num_avg - 1] - cs[o - 1], taken as two sums of the
// same stream.  A NaN or inf sample therefore has the plain version's
// effect wherever it lies: NaN from the first symbol whose window reaches
// a NaN, inf while the window holds an inf and NaN once it has left (inf
// - inf), on to the end of the block.  (num_avg 1 takes the energy itself,
// as the plain version does.)  The block walks virtual outputs v from
// -(num_avg - 1) to S - 1 in chunks of `chunk`; each chunk stages two
// pieces of the stream in shared memory by cp.async, double-buffered (the
// copy of chunk i+1 runs under the work on chunk i): the entering symbols
// [v0 + num_avg - 1, + chunk) and the symbols [v0 - 1, v0 + chunk), whose
// energies leave the sums and whose samples are the decision samples.
// Threads then add a chunk's energies per (bin, channel), the chunk split
// into parts so that every thread adds (each part's own sums, then, after
// a barrier, those plus the parts before it and the carry), and after a
// barrier take per (symbol, channel) the first-max bin and its sample.
// Rows that leave are read a second time num_avg symbols later (the 40 MB
// of a 1024 x 512 block at sps 8 fit the 50 MB L2, so that read need not
// reach HBM); shared memory grows with sps and the group, never with
// num_avg.
//
// Planes are float32, or int16 (kernel B1's int16 ingest: the REDHAWK
// dataShort wire) dequantized as i16 * scale where a sample is read from
// shared memory, so the staged copies move 2-byte rows (a group of 8
// channels is one 16-byte copy).  The fractional-timing variant
// (kInterp, B1's timing_interp mode) stages one more leaving symbol, so a
// chunk's last symbol can interpolate into the next symbol's first sample,
// and emits the circular-centroid pick instead of the first-max bin.
#pragma once

#include <stdint.h>

namespace psk {

// A sample as a float: float32 as it is, int16 dequantized as v * scale
// (one rounded multiply, the plain version's ``x.float() * in_scale``).
__device__ __forceinline__ float dequant(float v, float) { return v; }
__device__ __forceinline__ float dequant(int16_t v, float scale) {
  return __fmul_rn((float)v, scale);
}

// Time-major (rows, C) I/Q planes of element type T seen as one stream:
// rows [0, win_rows) come from `win`, the rest from `x`.  The window is the
// previous block's last rows (or a view of them), so nothing is
// concatenated in device memory.  `scale` dequantizes int16 planes.
template <class T>
struct PlanesT {
  const T* win_re;
  const T* win_im;
  const T* x_re;
  const T* x_im;
  int64_t win_rows;
  int C;
  float scale = 1.f;

  __device__ __forceinline__ void sample(int64_t r, int c, float& re,
                                         float& im) const {
    if (r < win_rows) {
      re = dequant(win_re[r * C + c], scale);
      im = dequant(win_im[r * C + c], scale);
    } else {
      re = dequant(x_re[(r - win_rows) * C + c], scale);
      im = dequant(x_im[(r - win_rows) * C + c], scale);
    }
  }

  __device__ __forceinline__ const T* row(int64_t r, bool im) const {
    return r < win_rows ? (im ? win_im : win_re) + r * C
                        : (im ? x_im : x_re) + (r - win_rows) * C;
  }
};

using TwoPlanes = PlanesT<float>;      // kernel B5's planes

// True when bin value v replaces `best` in a first-max scan over the bins
// in order: a strictly larger value, or the first NaN (NaN counts as the
// maximum, as torch.argmax and jnp.argmax treat it), so a poisoned window
// picks the same sample as the plain versions.
__device__ __forceinline__ bool takes_max(float v, float best) {
  return v > best || (v != v && best == best);
}

constexpr int kTimingThreads = 512;   // threads a block
constexpr int kTimingMaxGroup = 8;    // channels a block

// Pieces of a chunk the window sums are split into, so that every thread
// adds: kTimingThreads / (sps * group) of them, at most one a symbol.
__host__ __device__ __forceinline__ int timing_parts(int sps, int group,
                                                     int chunk) {
  const int p = kTimingThreads / (sps * group);
  return p < 1 ? 1 : (p > chunk ? chunk : p);
}

// Dynamic shared memory of timing_block: two staged chunks (each re and im
// of `chunk` entering and `chunk` + 1 + `lv_extra` leaving symbols, of
// `esize`-byte samples, rounded up to 16 bytes); the
// window sums of a chunk (symbol stride (sps + 1) * group, so the argmax's
// reads of four symbols fall in four banks) and the leaving sums' partials
// (stride sps * group); per part of a chunk its two totals; the two
// running sums, in two copies used in turn.
__host__ __device__ __forceinline__ int64_t timing_stage_bytes(
    int sps, int group, int chunk, int esize = 4, int lv_extra = 0) {
  const int64_t b = (int64_t)esize * 2 * 2 * (2 * chunk + 1 + lv_extra)
                    * sps * group;
  return (b + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int64_t timing_smem_bytes(
    int sps, int group, int chunk, int esize = 4, int lv_extra = 0) {
  const int64_t pairs = (int64_t)sps * group;
  return timing_stage_bytes(sps, group, chunk, esize, lv_extra)
         + 4 * ((int64_t)chunk * (pairs + group) + chunk * pairs
                + 2 * timing_parts(sps, group, chunk) * pairs + 4 * pairs);
}

// 0 when (group, chunk, vec) is a plan timing_block takes for these planes
// (ops/cuda/demod_kernel.timing_plan makes it): a group of 1-8 channels
// that is a whole number of copies, copies of 2 (int16 only), 4, 8 or 16
// bytes that fit the planes' row stride and addresses.
template <class T>
inline int timing_plan_error(const PlanesT<T>& in, int sps, int group,
                             int chunk, int vec) {
  const int es = (int)sizeof(T);
  if (group < 1 || group > kTimingMaxGroup || (group & (group - 1))
      || chunk < 1 || (vec != 4 && vec != 8 && vec != 16 && vec != es)
      || (es * group) % vec || (es * (int64_t)in.C) % vec || sps < 1)
    return 1;
  const T* ptrs[4] = {in.win_re, in.win_im, in.x_re, in.x_im};
  for (int i = in.win_rows ? 0 : 2; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % vec) return 1;
  return 0;
}

// A per-sample hook that does nothing (kernel B5).  A hook is called as
// note(energy, symbol, bin, channel) once for every sample of the stream
// (symbol counts rows of [window | block] in symbols), as it enters the
// window sums.
struct NoNote {
  __device__ __forceinline__ void operator()(float, int, int, int) const {}
};

__device__ __forceinline__ void timing_cp_async(void* dst, const void* src,
                                                int vec, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if (vec == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else      // 2 bytes (int16 planes of an odd channel count): a plain copy
    *static_cast<uint16_t*>(dst) =
        n ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
}

// Start the copies of symbols [s0, s0 + n) of channels [c0, c0 + group)
// of one plane (`im`) into a buffer laid out [symbol][bin][channel]; rows
// outside the stream and channels past C read as 0.  `lg` is log2 of the
// copies a row (group and vec are powers of two).
template <class T>
__device__ __forceinline__ void timing_stage(const PlanesT<T>& in, int sps,
                                             int group, int vec, int lg,
                                             int64_t rows, int s0, int n,
                                             int c0, bool im, T* buf) {
  const int total = (n * sps) << lg;
  const int64_t r0 = (int64_t)s0 * sps;
  const int per = vec / (int)sizeof(T);    // samples a copy
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int ri = e >> lg;                 // row within the piece
    const int c = c0 + (e - (ri << lg)) * per;
    const int64_t r = r0 + ri;
    const bool ok = r >= 0 && r < rows && c < in.C;
    timing_cp_async(buf + ri * group + (c - c0),
                    ok ? in.row(r, im) + c : in.x_re, vec, ok ? vec : 0);
  }
}

// Fractional timing (kernel B1's timing_interp): per bin j, cos and sin of
// j * 2pi / sps, and sps / 2pi; both are float32 values the wrapper
// computes once, so the kernel and its plain version use the same ones.
struct InterpTable {
  const float* cos;
  const float* sin;
  float scale;
};

// The block loop over channels [blockIdx.x * group, + group) and all S
// output symbols; `smem` holds timing_smem_bytes(sps, group, chunk,
// sizeof(T), kInterp).  emit(o, c, bin, re, im) is called once for each
// (symbol, channel) with the first-max bin and its sample, or with
// kInterp the centroid pick (the plain version's _frontend_interp rule,
// ops/cuda/demod_kernel.py): p = atan2(sum_j W_j sin_j, sum_j W_j cos_j)
// * sps / 2pi moved into [-0.5, sps - 0.5], bin round(p) % sps, and the
// sample interpolated between stream samples o * sps + floor(p) and the
// next (row o - 1's last, row o + 1's first at the edges), frac = p -
// floor(p); output 0 of the call takes its own first sample when floor(p)
// < 0; a NaN p takes bin 0 and sample 0 with frac NaN.  note as above.
template <bool kInterp = false, class T, class Emit, class Note>
__device__ __forceinline__ void timing_block(const PlanesT<T>& in, int S,
                                             int sps, int num_avg, int group,
                                             int chunk, int vec, float* smem,
                                             Emit emit, Note note,
                                             InterpTable it = {}) {
  const int c0 = blockIdx.x * group;
  const int lead = num_avg - 1;             // warm-up outputs
  const int64_t rows = (int64_t)(S + lead) * sps;
  const int nchunks = (S + lead + chunk - 1) / chunk;
  const int lg = __ffs((int)sizeof(T) * group / vec) - 1;
  const int pairs = sps * group;            // (bin, channel) pairs
  const int in_f = chunk * pairs;           // samples of one entering plane
  const int lv_f = (chunk + 1 + kInterp) * pairs;
  const int stage_f = 2 * (in_f + lv_f);
  const int sstride = pairs + group;        // window sums: floats a symbol
  const int parts = timing_parts(sps, group, chunk);
  const int part_len = (chunk + parts - 1) / parts;
  T* const stage = reinterpret_cast<T*>(smem);
  float* const sums = reinterpret_cast<float*>(                // P_in too
      reinterpret_cast<char*>(smem)
      + timing_stage_bytes(sps, group, chunk, sizeof(T), kInterp));
  float* const outs = sums + chunk * sstride;           // P_out partials
  float* const tot = outs + chunk * pairs;   // [2][parts][pairs]
  float* const carry = tot + 2 * parts * pairs;          // [2][2][pairs]

  auto issue = [&](int i) {
    if (i < nchunks) {
      T* st = stage + (i & 1) * stage_f;
      const int v0 = i * chunk - lead;
      timing_stage(in, sps, group, vec, lg, rows, v0 + lead, chunk, c0,
                   false, st);
      timing_stage(in, sps, group, vec, lg, rows, v0 + lead, chunk, c0,
                   true, st + in_f);
      timing_stage(in, sps, group, vec, lg, rows, v0 - 1,
                   chunk + 1 + kInterp, c0, false, st + 2 * in_f);
      timing_stage(in, sps, group, vec, lg, rows, v0 - 1,
                   chunk + 1 + kInterp, c0, true, st + 2 * in_f + lv_f);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int p = threadIdx.x; p < 2 * pairs; p += blockDim.x) carry[p] = 0.f;
  issue(0);

  for (int i = 0; i < nchunks; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk i staged; chunk i-1's buffers and sums free
    issue(i + 1);
    const T* st = stage + (i & 1) * stage_f;
    const T* in_re = st;
    const T* in_im = st + in_f;
    const T* lv_re = st + 2 * in_f;
    const T* lv_im = lv_re + lv_f;
    const int v0 = i * chunk - lead;
    const int len = min(chunk, S - v0);     // outputs (real or warm-up)
    const float* cin = carry + (i & 1) * 2 * pairs;      // sums so far
    float* const cnext = carry + ((i & 1) ^ 1) * 2 * pairs;

    // The window sums, in two passes over (part, pair): each part's own
    // running sums of its symbols, then those plus the parts before it and
    // the carry.
    for (int w = threadIdx.x; w < parts * pairs; w += blockDim.x) {
      const int q = w / pairs, pr = w - q * pairs;
      const int j = pr / group, c = c0 + pr - j * group;
      const int k1 = min(len, (q + 1) * part_len);
      float lin = 0.f, lout = 0.f;
#pragma unroll 4
      for (int k = q * part_len; k < k1; ++k) {
        const int x = k * pairs + pr;
        const float ir = dequant(in_re[x], in.scale);
        const float ii = dequant(in_im[x], in.scale);
        const float lr = dequant(lv_re[x], in.scale);
        const float li = dequant(lv_im[x], in.scale);
        const float ein = ir * ir + ii * ii;
        const float eout = lr * lr + li * li;
        if (c < in.C) note(ein, v0 + lead + k, j, c);
        lin += ein;
        lout += eout;
        sums[k * sstride + pr] = num_avg == 1 ? ein : lin;
        outs[x] = lout;
      }
      tot[w] = lin;
      tot[parts * pairs + w] = lout;
    }
    __syncthreads();
    for (int w = threadIdx.x; w < parts * pairs; w += blockDim.x) {
      const int q = w / pairs, pr = w - q * pairs;
      float oin = cin[pr], oout = cin[pairs + pr];
      for (int u = 0; u < q; ++u) {
        oin += tot[u * pairs + pr];
        oout += tot[(parts + u) * pairs + pr];
      }
      const int k1 = min(len, (q + 1) * part_len);
      if (num_avg > 1)
#pragma unroll 4
        for (int k = q * part_len; k < k1; ++k)
          sums[k * sstride + pr] =
              (oin + sums[k * sstride + pr]) - (oout + outs[k * pairs + pr]);
      if (q == parts - 1) {
        cnext[pr] = oin + tot[w];
        cnext[pairs + pr] = oout + tot[parts * pairs + w];
      }
    }
    __syncthreads();

    // The pick and its sample, per (symbol, channel).
    for (int q = threadIdx.x; q < len * group; q += blockDim.x) {
      const int k = q / group, g = q - k * group;
      const int o = v0 + k;
      if (o < 0 || c0 + g >= in.C) continue;
      const float* col = sums + k * sstride + g;
      if constexpr (kInterp) {
        float zr = 0.f, zi = 0.f;
        for (int j = 0; j < sps; ++j) {
          const float v = col[j * group];
          zr += v * it.cos[j];
          zi += v * it.sin[j];
        }
        float p = atan2f(zi, zr) * it.scale;
        if (p < -0.5f) p += (float)sps;
        if (p > (float)sps - 0.5f) p -= (float)sps;
        const bool nan = p != p;
        const int b = nan ? 0 : (int)rintf(p) % sps;
        float i0f = floorf(p);
        float frac = __fsub_rn(p, i0f);
        if (o == 0 && i0f < 0.f) {          // no sample before the call's
          i0f = 0.f;
          frac = 0.f;
        }
        const int at = ((k + 1) * sps + (nan ? 0 : (int)i0f)) * group + g;
        const float w1 = __fsub_rn(1.f, frac);
        const float s0r = dequant(lv_re[at], in.scale);
        const float s0i = dequant(lv_im[at], in.scale);
        const float s1r = dequant(lv_re[at + group], in.scale);
        const float s1i = dequant(lv_im[at + group], in.scale);
        emit(o, c0 + g, b,
             __fadd_rn(__fmul_rn(s0r, w1), __fmul_rn(s1r, frac)),
             __fadd_rn(__fmul_rn(s0i, w1), __fmul_rn(s1i, frac)));
      } else {
        int b = 0;
        float best = col[0];
        for (int j = 1; j < sps; ++j) {
          const float v = col[j * group];
          if (takes_max(v, best)) {
            best = v;
            b = j;
          }
        }
        const int at = ((k + 1) * sps + b) * group + g;   // symbol o
        emit(o, c0 + g, b, dequant(lv_re[at], in.scale),
             dequant(lv_im[at], in.scale));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace psk
