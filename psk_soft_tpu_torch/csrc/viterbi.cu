// Kernels B2, B3 and B4 for Hopper (sm_90a): the Viterbi decoder.
//
// Replaces the Pallas kernels of psk_soft_tpu/ops/pallas/viterbi_kernel.py:
//   B2 viterbi_fused      (_fused_kernel): ACS over the whole trellis and
//                          the traceback in one launch, decisions on chip;
//   B3 viterbi_acs        (_acs_kernel): ACS with the path metrics carried
//                          over the whole trellis, int8 decisions to memory;
//   B4 viterbi_traceback  (_back_kernel): the survivor walk back from a
//                          start state over those decisions.
// Layouts are the Pallas ones: LLRs (n, T_pad, B), metrics (S, B),
// butterfly signs (2S, n), decisions (T_pad, S, B), bits (T_pad, B), with
// B decode rows (frames x channels) and S = 2^(K-1) states.  Only the
// first t_actual steps are computed; the wrappers zero the padding rows.
//
// Arithmetic (exact, kept term for term from _acs_step and ops/fec):
//   state s' = (S/2)*a + j has the predecessors 2j and 2j+1, and
//   butterfly rows a*S + 2j + p hold their expected signs;
//   bm_p = e[.,0]*l0, then bm_p += e[.,i]*li for i = 1..n-1;
//   c_p = pm[2j+p] + bm_p; decision = (c1 > c0) (a tie keeps p = 0);
//   pm' = new - new[state 0] (re-zero against state 0, not the max).
// The signs are +/-1, so every product is exact and a fused multiply-add
// rounds as the plain version's multiply then add.  For n = 2 (every
// preset) a lane keeps its butterflies' signs as floats; for other n as
// bits of one word per butterfly, flipping the LLR's sign bit, which is
// the product exactly.  The metrics are re-zeroed lazily: a step keeps
// the new metrics as they are and the next step subtracts state 0's entry
// when it reads them, the same float subtraction the plain version does
// at the end of the step (step 0 reads pm0 as it is).  Traceback
// (ops/fec._make_back): the bit of step t is (s >> (K-2)) & 1, then s =
// ((s << 1) & (S-1)) | dec[t][s]; the start is state 0 (terminate) or the
// first maximum of the final metrics, a NaN counting as the maximum as in
// torch.argmax (psk::takes_max).  B4 takes any int32 start: outside [0,
// S) its first bit comes from the raw value and its first decision reads
// 0, as the Pallas _back_kernel's one-hot lookup does.
//
// Design (B2 and B3 share one ACS core, acs_steps).  A decode row's states
// live in the registers of one warp: the row takes L = min(32, S/2) lanes
// and lane l holds the Q = S/L states l + L*q (K7: lanes 0-31, states l
// and l+32; K <= 6: 64/S rows share a warp, the shuffles' width set to L;
// K8-K10: 4, 8 or 16 states a lane).  Lane l computes the butterflies j =
// l + L*m: their predecessors 2j and 2j+1 come from lanes (2l) mod L and
// (2l+1) mod L by __shfl_sync (both slots are shuffled and the lane
// selects, so no register index depends on the lane), and state 0's
// metric for the re-zero by one more shuffle.  The per-step loop has no
// block barrier and reads nothing from device memory: a block of W
// consecutive rows stages its (n, Tc, W) LLR tile in shared memory with
// cp.async, double-buffered, the copy of chunk c+1 running under the ACS
// of chunk c, one __syncthreads a chunk.  The next step's branch metrics
// are formed during a step from LLRs loaded a step earlier still, so no
// shared-memory load waits on the chain.  A lane gathers its own decision
// bits in registers and stores one word per state and 32-step group (S/32
// words a row and step: 8 bytes a step at K7; a chunk that ends inside a
// group leaves the lane's word part-filled and the next chunk ORs in the
// rest), so the step has no ballot and no store.
//   B2 keeps every step's words in shared memory; after the ACS each row's
//   warp finds its start state by a shuffle reduction, and one thread per
//   row (one warp per block at K7) walks the traceback there.
//   B3 double-buffers one chunk of words: 4 writer warps a block stage the
//   next chunk's LLRs and write the previous chunk's words to (T_pad, S,
//   B) as bytes, rows fastest, in contiguous pieces of W bytes (4-byte
//   stores where B % 4 == 0), while the ACS warps run the current chunk.
// B4 (viterbi_segments_kernel, then viterbi_resolve_kernel).  A step's S
// decisions can be loaded before its state is known, and a walk can be
// cut into segments: a segment walked back from every one of the S states
// gives a map from the state entering it (from later steps) to the state
// leaving it, and the bits of each of those S walks.  Pass 1: a block of
// kTbRows = 32 consecutive rows by one segment of the t_actual - 1 steps
// before the last; three copy warps stage (Tc, S, 32) tiles of the plane
// into shared memory by cp.async (16 or 4 bytes a copy where B allows it,
// else a byte load and store), latest steps first, three tiles ahead, one
// barrier a tile; up to 16 walker warps, lane = row, walk the S end states
// (S / 16 walks a thread at K >= 5) in shared memory only, storing each
// walk's bits once per 32 steps and its final state.  Pass 2: one thread
// a row takes the last step from the start state, chains the segments'
// maps down to the state entering each segment and expands the 32-step
// words of those walks into bit rows.  The plan (bytes a copy, Tc,
// segment length, segments, shared memory, grid) comes from Python
// (viterbi_kernel.traceback_plan) and is only checked here
// (traceback_plan.h).  What bounds it: reading the plane once is 134 MB
// at K7 512 x 4096, 0.04 ms at 3.35 TB/s; a single walk is a chain of
// 4096 dependent shared-memory loads (some 35-45 cycles each, 0.07-0.09
// ms at 1.98 GHz), which the segments cut 16-fold for S times the loads.
// The earlier designs: one thread per row reading the plane in device
// memory at each dependent step (2.04 ms there); one walker warp per 32
// rows reading staged tiles (0.80 ms: 16 blocks took the plane in at
// about 10 GB/s an SM).
//
// What bounds them on an H100.  By the roofline, B2 at the chain shape
// (K7, n 2, 64 steps, 6144 rows) is bound by operations (about 11 per
// step, row and state: 277 M, 4 us at 67 TFLOP/s) and B3 at K7, 512 rows
// x 4096 steps by the bytes of its decision plane (134 MB, 40 us at 3.35
// TB/s).  But a row's steps form a dependent chain: a shuffle (some 25
// cycles), then a select, the re-zero, the add, the compare and the
// select (about 5 cycles each), some 55-66 cycles a step, so B3's 4096
// steps take at least 4096 x 55-66 / 1.98 GHz (the H100 SXM's boost
// clock) = 0.11-0.14 ms whatever the row count.  In the kernel a step
// takes about 200 cycles: B3's 512 rows are 64 blocks, one an SM, and one
// block of 8 rows alone takes nearly as long (0.40 against 0.43 ms,
// tools/kernel_times.py), so the step's latency inside a block bounds it:
// two ACS warps and a writer warp share each scheduler, and writing the
// decision plane keeps the writer warps about as busy as the ACS.  B2's
// 6144 warps are bound by the issue rate, about 45 instructions a warp
// and step.
// ptxas (-Xptxas -v, printed by chip_smoke.py phase 2): no instantiation
// spills; B2 at K7 takes 38 registers (6 blocks an SM, the chain shape in
// one wave), B3 at K7 78.
//
// The launch plan (make_plan, and its twin launch_plan in
// psk_soft_tpu_torch/ops/cuda/viterbi_kernel.py) sizes the blocks: B2
// starts from 8 warps a block (at most 64 rows), B3 from kAcsRows rows (W
// = 8 measured faster than 4 and 16) and kWriterWarps writer warps (4
// measured faster than 2 and 8), chunks of up to 64 steps; where that
// overflows the 48 KB of shared memory a block has without opting in, it
// halves the warps a block, then the chunk.  B2 takes trellises of up to
// kFusedMaxSteps steps (kFusedMaxStepsK10 at K10), within which the plan
// fits at every n; the callers send longer ones to B3 + B4, so which path
// a decode takes does not depend on the blocks' sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "timing.cuh"
#include "traceback_plan.h"

namespace {

constexpr int kMaxN = 8;            // code outputs per trellis step
constexpr int kMaxK = 10;           // 512 states
constexpr int kSmemLimit = 48 * 1024;
constexpr int kMaxChunk = 64;       // trellis steps per staged chunk
constexpr int kSlack = 2;           // steps past a chunk the look-ahead reads
constexpr int kFusedWarps = 8;      // B2: warps a block ...
constexpr int kFusedMaxRows = 64;   // ... and at most this many rows
constexpr int kFusedMaxSteps = 1472;     // B2's longest trellis, K <= 9 ...
constexpr int kFusedMaxStepsK10 = 704;   // ... and at K10
constexpr int kAcsRows = 8;         // B3: rows a block
constexpr int kWriterWarps = 4;     // B3: warps that stage and write out
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* llr;     // (n, T_pad, B)
  const float* pm0;     // (S, B)
  const float* exp;     // (2S, n) butterfly signs
  int8_t* dec;          // B3: (T_pad, S, B) decisions
  float* pm_out;        // B3: (S, B) final metrics
  int8_t* bits;         // B2: (T_pad, B) decoded bits
  int n, S, k, T_pad, t_actual, B, terminate;
};

struct Plan {
  int lanes;            // lanes a row: min(32, S/2)
  int rows_per_warp;    // 32 / lanes
  int warps;            // ACS warps a block (B3 adds kWriterWarps)
  int rows;             // rows a block, W = warps * rows_per_warp
  int chunk;            // trellis steps a staged LLR chunk, Tc
  int smem;             // dynamic shared memory a block, bytes
  int grid;             // blocks
  int threads;          // threads a block
};

bool bad_code(int n, int S, int k) {
  return n < 1 || n > kMaxN || k < 2 || k > kMaxK || S != (1 << (k - 1));
}

int fused_max_steps(int S) {
  return S > 256 ? kFusedMaxStepsK10 : kFusedMaxSteps;
}

// Shared memory: the decision words (B2: every step; B3: two buffers of
// one chunk) then the LLR buffers (two when the trellis has more than one
// chunk).
int64_t plan_smem(bool fused, int S, int n, int t, int warps, int rows,
                  int chunk) {
  const int lanes = S / 2 < 32 ? S / 2 : 32;
  const int64_t slots = S / lanes;
  const int64_t word_steps = ((int64_t)(fused ? t : chunk) + 31) / 32 * 32;
  const int64_t word_buffers = fused ? 1 : 2;
  const int64_t buffers = t > chunk ? 2 : 1;
  return word_buffers * word_steps * warps * slots * 4
         + buffers * n * (chunk + kSlack) * rows * 4;
}

// 0 and *pl filled, or cudaErrorInvalidValue for a launch the kernels do
// not take.
int make_plan(bool fused, int S, int n, int t, int B, Plan* pl) {
  if (S < 2 || S > (1 << (kMaxK - 1)) || (S & (S - 1)) || n < 1
      || n > kMaxN || t < 0 || B < 0 || (fused && t > fused_max_steps(S)))
    return (int)cudaErrorInvalidValue;
  pl->lanes = S / 2 < 32 ? S / 2 : 32;
  pl->rows_per_warp = 32 / pl->lanes;
  const int rows = fused ? (kFusedWarps * pl->rows_per_warp < kFusedMaxRows
                                ? kFusedWarps * pl->rows_per_warp
                                : kFusedMaxRows)
                         : kAcsRows;
  pl->warps = rows / pl->rows_per_warp;
  if (pl->warps < 1) pl->warps = 1;
  // Up to 64 steps a chunk; over the budget, halve the warps, then the
  // chunk.
  pl->chunk = t < kMaxChunk ? (t > 0 ? t : 1) : kMaxChunk;
  int64_t smem;
  while ((smem = plan_smem(fused, S, n, t, pl->warps,
                           pl->warps * pl->rows_per_warp, pl->chunk))
         > kSmemLimit) {
    if (pl->warps > 1)
      pl->warps /= 2;
    else if (pl->chunk > 1)
      pl->chunk /= 2;
    else
      return (int)cudaErrorInvalidValue;
  }
  pl->rows = pl->warps * pl->rows_per_warp;
  pl->smem = (int)smem;
  pl->grid = (B + pl->rows - 1) / pl->rows;
  pl->threads = (pl->warps + (fused ? 0 : kWriterWarps)) * 32;
  return 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool copy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(copy ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of steps [t0, t0 + len) of the block's rows into `buf`,
// laid out [i][step][row] with chunk + kSlack steps per i, by threads tid
// of nthreads; rows past B read 0.
__device__ void stage_llr(const Params& p, float* buf, int t0, int len,
                          int chunk, int rows, int b0, int tid,
                          int nthreads) {
  const int total = p.n * len * rows;
  for (int e = tid; e < total; e += nthreads) {
    const int r = e % rows;
    const int rest = e / rows;
    const int tt = rest % len;
    const int i = rest / len;
    const bool in = b0 + r < p.B;
    const float* src =
        in ? p.llr + ((size_t)i * p.T_pad + t0 + tt) * p.B + b0 + r : p.llr;
    cp_async4(buf + (i * (chunk + kSlack) + tt) * rows + r, src, in);
  }
  cp_async_commit();
}

// e*l for e = +/-1: l with its sign bit flipped where bit `bit` of w is
// set, which is the product exactly.
__device__ __forceinline__ float signed_llr(float l, uint32_t w, int bit) {
  return __int_as_float(__float_as_int(l) ^ (((w >> bit) & 1u) << 31));
}

// The signs of one lane's butterflies j = l + L*m, branch br = 2a + p
// (butterfly row a*S + 2j + p).  N > 0 (n = N, the presets' n = 2): floats
// e[m][br][i] = +/-1, one product or fused add a term (exact: e*l is).
// N == 0 (any n): bit 8*br + i of one word per butterfly, set where the
// sign is -1, flipped into the LLR.
template <int Q, int N>
struct Signs {
  static constexpr int J = Q / 2;
  float e[J][4][N > 0 ? N : 1];
  uint32_t w[J];

  __device__ __forceinline__ void load(const Params& p, int l, int lanes) {
#pragma unroll
    for (int m = 0; m < J; ++m) {
      const int j = l + lanes * m;
      w[m] = 0;
#pragma unroll
      for (int br = 0; br < 4; ++br) {
        const float* row =
            p.exp + (size_t)((br >> 1) * p.S + 2 * j + (br & 1)) * p.n;
        if constexpr (N > 0) {
#pragma unroll
          for (int i = 0; i < N; ++i) e[m][br][i] = row[i];
        } else {
          for (int i = 0; i < p.n; ++i)
            if (row[i] < 0.f) w[m] |= 1u << (8 * br + i);
        }
      }
    }
  }

  // The LLRs of one step, l_i at lp[i * stride] (N > 0).
  __device__ __forceinline__ void load_llrs(float (&lv)[N > 0 ? N : 1],
                                            const float* lp,
                                            int stride) const {
#pragma unroll
    for (int i = 0; i < (N > 0 ? N : 1); ++i) lv[i] = lp[i * stride];
  }

  // Branch metrics from a step's LLRs (N > 0): e_0*l_0, then + e_i*l_i
  // in order, as the plain version sums them.
  __device__ __forceinline__ void combine(float (&bm)[J][4],
                                          const float (&lv)[N > 0 ? N : 1])
      const {
#pragma unroll
    for (int m = 0; m < J; ++m)
#pragma unroll
      for (int br = 0; br < 4; ++br) {
        float s = e[m][br][0] * lv[0];
#pragma unroll
        for (int i = 1; i < N; ++i) s = s + e[m][br][i] * lv[i];
        bm[m][br] = s;
      }
  }

  // Branch metrics of one step straight from shared memory (N == 0, any
  // n), in the same order.
  __device__ __forceinline__ void metrics(float (&bm)[J][4], const float* lp,
                                          int stride, int n) const {
    const float l0 = lp[0];
#pragma unroll
    for (int m = 0; m < J; ++m)
#pragma unroll
      for (int br = 0; br < 4; ++br)
        bm[m][br] = signed_llr(l0, w[m], 8 * br);
    for (int i = 1; i < n; ++i) {
      const float li = lp[i * stride];
#pragma unroll
      for (int m = 0; m < J; ++m)
#pragma unroll
        for (int br = 0; br < 4; ++br)
          bm[m][br] = bm[m][br] + signed_llr(li, w[m], 8 * br + i);
    }
  }
};

// Where a lane sits: its row's lanes, row in the warp, lane in the row,
// row in the block, row, warp.
struct Lane {
  int lanes, rr, l, rb, b, wp;
  bool valid;
};

// The ACS core: `len` steps of one lane's states from the staged LLRs
// (`cur`, [i][step][row], `stride` floats per i, two steps of slack past
// the chunk).  pm holds the lane's metrics as they are (not re-zeroed), z
// state 0's metric to subtract (0 before step 0).  The branch metrics of
// the next step are formed during this one, from LLRs loaded a step
// earlier still (n = 2), so no shared-memory load sits on the chain; the
// look-ahead reads into the slack past the chunk's end.  Each lane gathers
// its own decision bits, bit (step0 + step) % 32 of word ((group * warps +
// wp) * 32 + lane) * Q + q for group (step0 + step) / 32, in acc[q] and
// stores them once a group, or once for the part of a group the chunk
// holds (OR-ed into the word when the group began in an earlier chunk).
template <int Q, int N>
__device__ __forceinline__ void acs_steps(const Lane& ln, float (&pm)[Q],
                                          float& z, const Signs<Q, N>& sg,
                                          const float* cur, int stride,
                                          int rows, int n, int len,
                                          uint32_t* words, int step0,
                                          int warps) {
  constexpr int J = Q / 2;
  const int src0 = 2 * ln.l, src1 = 2 * ln.l + 1;
  const bool h0 = src0 >= ln.lanes, h1 = src1 >= ln.lanes;
  const float* lp = cur + ln.rb;
  uint32_t* wlane = words + (ln.wp * 32 + (threadIdx.x & 31)) * Q;
  float bm[J][4];
  float lv[N > 0 ? N : 1];
  if constexpr (N > 0) {
    sg.load_llrs(lv, lp, stride);
    sg.combine(bm, lv);
    sg.load_llrs(lv, lp + rows, stride);
    lp += 2 * rows;                         // the step after next
  } else {
    sg.metrics(bm, lp, stride, n);
    lp += rows;                             // the next step
  }
  for (int g0 = 0; g0 < len;) {
    const int off = (step0 + g0) & 31;     // the group's steps before g0
    const int cnt = len - g0 < 32 - off ? len - g0 : 32 - off;
    uint32_t acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0;
    for (int i = 0; i < cnt; ++i) {
      float nw[Q];
      bool d[Q];
#pragma unroll
      for (int m = 0; m < J; ++m) {
        const float a0 = __shfl_sync(kFull, pm[2 * m], src0, ln.lanes);
        const float a1 = __shfl_sync(kFull, pm[2 * m + 1], src0, ln.lanes);
        const float b0 = __shfl_sync(kFull, pm[2 * m], src1, ln.lanes);
        const float b1 = __shfl_sync(kFull, pm[2 * m + 1], src1, ln.lanes);
        const float pa = (h0 ? a1 : a0) - z;
        const float pb = (h1 ? b1 : b0) - z;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float c0 = pa + bm[m][2 * a];
          const float c1 = pb + bm[m][2 * a + 1];
          d[m + a * J] = c1 > c0;
          nw[m + a * J] = d[m + a * J] ? c1 : c0;
        }
      }
      if constexpr (N > 0) {                // the next step's metrics
        sg.combine(bm, lv);
        sg.load_llrs(lv, lp, stride);
      } else {
        sg.metrics(bm, lp, stride, n);
      }
      lp += rows;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        pm[q] = nw[q];
        acc[q] = (acc[q] >> 1) | (d[q] ? 0x80000000u : 0u);
      }
      z = __shfl_sync(kFull, pm[0], 0, ln.lanes);
    }
    uint32_t* dst = wlane + ((step0 + g0) >> 5) * warps * 32 * Q;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const uint32_t bits = acc[q] >> (32 - cnt) << off;
      dst[q] = off ? dst[q] | bits : bits;
    }
    g0 += cnt;
  }
}

// B3's write-out of one chunk's words (acs_steps' layout) to (T_pad, S,
// B), rows fastest, by threads tid of nthreads.  Task (32-step group,
// state, 4 rows) takes the 4 rows' words of that state and walks the
// group's steps: one 4-byte store a step where B % 4 == 0, else bytes.
template <int Q>
__device__ void write_decisions(const Params& p, const Plan& pl,
                                const uint32_t* words, int t0, int len,
                                int b0, int tid, int nthreads) {
  const int S = p.S;
  const int groups4 = (pl.rows + 3) / 4;
  const bool vec = (p.B & 3) == 0 && (pl.rows & 3) == 0;
  const int tasks = ((len + 31) >> 5) * S * groups4;
  const size_t step_stride = (size_t)S * p.B;
  for (int u = tid; u < tasks; u += nthreads) {
    const int g = u % groups4;
    const int s = (u / groups4) % S;
    const int gi = u / groups4 / S;
    const int q = s / pl.lanes;
    uint32_t w4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * g + k;
      const int wpr = r / pl.rows_per_warp;
      const int lane_r =
          (r - wpr * pl.rows_per_warp) * pl.lanes + s - q * pl.lanes;
      w4[k] = r < pl.rows
                  ? words[((gi * pl.warps + wpr) * 32 + lane_r) * Q + q]
                  : 0u;
    }
    const int steps_here = len - 32 * gi < 32 ? len - 32 * gi : 32;
    int8_t* dst =
        p.dec + ((size_t)(t0 + 32 * gi) * S + s) * p.B + b0 + 4 * g;
    const bool full = vec && b0 + 4 * g < p.B;
    for (int i = 0; i < steps_here; ++i, dst += step_stride) {
      const uint32_t out = (w4[0] & 1u) | (w4[1] & 1u) << 8
                           | (w4[2] & 1u) << 16 | (w4[3] & 1u) << 24;
#pragma unroll
      for (int k = 0; k < 4; ++k) w4[k] >>= 1;
      if (full) {
        *reinterpret_cast<uint32_t*>(dst) = out;
      } else {
        for (int k = 0; k < 4; ++k)
          if (4 * g + k < pl.rows && b0 + 4 * g + k < p.B)
            dst[k] = (int8_t)((out >> (8 * k)) & 1u);
      }
    }
  }
}

// One row's first maximum over its lanes: (value, state), a NaN counting
// as the maximum and the lower state winning a tie, as torch.argmax.
__device__ __forceinline__ bool first_of(float a, int ia, float b, int ib) {
  if (a != a) return b != b ? ia < ib : true;
  if (b != b) return false;
  return a == b ? ia < ib : a > b;
}

// Launch bounds: B2 runs up to 8 warps a block, 6 blocks an SM at K7 (the
// chain shape's 768 blocks in one wave); B3 up to 8 ACS warps and its
// writer warps.
template <int Q, int N, bool kFused>
__global__ void __launch_bounds__(
    (kFused ? kFusedWarps : kAcsRows + kWriterWarps) * 32,
    kFused && Q == 2 ? 6 : 1)
    viterbi_warp_kernel(const Params p, const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  Lane ln;
  ln.lanes = pl.lanes;
  ln.wp = threadIdx.x >> 5;
  ln.rr = lane / pl.lanes;
  ln.l = lane - ln.rr * pl.lanes;
  ln.rb = ln.wp * pl.rows_per_warp + ln.rr;
  const int b0 = blockIdx.x * pl.rows;
  ln.b = b0 + ln.rb;
  ln.valid = ln.b < p.B && ln.wp < pl.warps;
  const int S = p.S, n = p.n, steps = p.t_actual, chunk = pl.chunk;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* llr_buf = reinterpret_cast<float*>(
      smem + (size_t)(kFused ? 1 : 2)
                 * (((kFused ? steps : chunk) + 31) / 32 * 32) * pl.warps * Q
                 * 4);
  const int stride = (chunk + kSlack) * pl.rows;   // floats per output i
  const int llr_stride = n * stride;        // floats per buffer

  Signs<Q, N> sg;
  sg.load(p, ln.l, pl.lanes);
  float pm[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    pm[q] = ln.valid ? p.pm0[(size_t)(ln.l + pl.lanes * q) * p.B + ln.b]
                     : 0.f;

  float z = 0.f;
  const int nchunks = (steps + chunk - 1) / chunk;
  if constexpr (kFused) {
    // Every thread stages; the copy of chunk ci+1 runs under chunk ci.
    if (steps > 0)
      stage_llr(p, llr_buf, 0, steps < chunk ? steps : chunk, chunk,
                pl.rows, b0, threadIdx.x, blockDim.x);
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = ci * chunk;
      cp_async_wait_all();
      __syncthreads();  // chunk ci staged, chunk ci-1's buffer free
      if (c0 + chunk < steps)
        stage_llr(p, llr_buf + ((ci + 1) & 1) * llr_stride, c0 + chunk,
                  steps - c0 - chunk < chunk ? steps - c0 - chunk : chunk,
                  chunk, pl.rows, b0, threadIdx.x, blockDim.x);
      acs_steps<Q, N>(ln, pm, z, sg, llr_buf + (ci & 1) * llr_stride, stride,
                      pl.rows, n, steps - c0 < chunk ? steps - c0 : chunk,
                      words, c0, pl.warps);
    }
  } else {
    // The writer warps stage chunk ci+1 and write out chunk ci-1 while the
    // ACS warps run chunk ci: one barrier a chunk, two word buffers.
    const int word_stride = (chunk + 31) / 32 * 32 * pl.warps * Q;
    const bool writer = ln.wp >= pl.warps;
    const int wt = threadIdx.x - pl.warps * 32;
    const int nwt = kWriterWarps * 32;
    if (writer && steps > 0) {
      stage_llr(p, llr_buf, 0, steps < chunk ? steps : chunk, chunk, pl.rows,
                b0, wt, nwt);
      cp_async_wait_all();
    }
    __syncthreads();
    for (int ci = 0; ci <= nchunks; ++ci) {
      const int c0 = ci * chunk;
      if (!writer) {
        if (ci < nchunks)
          acs_steps<Q, N>(ln, pm, z, sg, llr_buf + (ci & 1) * llr_stride,
                          stride, pl.rows, n,
                          steps - c0 < chunk ? steps - c0 : chunk,
                          words + (ci & 1) * word_stride, 0, pl.warps);
      } else {
        if (ci + 1 < nchunks)
          stage_llr(p, llr_buf + ((ci + 1) & 1) * llr_stride, c0 + chunk,
                    steps - c0 - chunk < chunk ? steps - c0 - chunk : chunk,
                    chunk, pl.rows, b0, wt, nwt);
        if (ci > 0)
          write_decisions<Q>(p, pl, words + ((ci - 1) & 1) * word_stride,
                             c0 - chunk,
                             steps - c0 + chunk < chunk ? steps - c0 + chunk
                                                        : chunk,
                             b0, wt, nwt);
        cp_async_wait_all();
      }
      __syncthreads();  // chunk ci done and ci+1 staged; ci-1 written
    }
  }

  // Final metrics, re-zeroed (pm0 itself when there were no steps).
  float fin[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) fin[q] = steps > 0 ? pm[q] - z : pm[q];
  if (!kFused) {
    if (ln.valid)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        p.pm_out[(size_t)(ln.l + pl.lanes * q) * p.B + ln.b] = fin[q];
    return;
  }

  // The start states (B2): state 0, or each row's first maximum from a
  // reduction over its lanes, through shared memory (the LLR buffers are
  // free now) to one thread per row, which walks the row's words.
  int* starts = reinterpret_cast<int*>(llr_buf);
  int start = 0;
  if (!p.terminate) {
    float best = fin[0];
    int idx = ln.l;
#pragma unroll
    for (int q = 1; q < Q; ++q)
      if (psk::takes_max(fin[q], best)) {
        best = fin[q];
        idx = ln.l + pl.lanes * q;
      }
    for (int off = pl.lanes / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off, pl.lanes);
      const int oi = __shfl_xor_sync(kFull, idx, off, pl.lanes);
      if (first_of(ob, oi, best, idx)) {
        best = ob;
        idx = oi;
      }
    }
    start = idx;
  }
  __syncthreads();  // every warp is past its last read of the LLR buffers
  if (ln.l == 0) starts[ln.rb] = start;
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= pl.rows || b0 + r >= p.B) return;
  const int lg = __ffs(pl.lanes) - 1;      // lanes is a power of two
  const int wpr = r / pl.rows_per_warp;
  const uint32_t* rw =
      words + (wpr * 32 + (r - wpr * pl.rows_per_warp) * pl.lanes) * Q;
  const int gstride = pl.warps * 32 * Q;
  int st = starts[r];
  int8_t* out = p.bits + b0 + r;
  for (int t = steps - 1; t >= 0; --t) {
    out[(size_t)t * p.B] = (int8_t)((st >> (p.k - 2)) & 1);
    const uint32_t w =
        rw[(t >> 5) * gstride + (st & (pl.lanes - 1)) * Q + (st >> lg)];
    st = ((st << 1) & (S - 1)) | (int)((w >> (t & 31)) & 1u);
  }
}

struct TbParams {
  const int8_t* dec;        // (T_pad, S, B)
  const int32_t* start;     // (B,)
  int8_t* bits;             // (T_pad, B)
  uint32_t* words;          // (ceil(steps / 32), S, B) scratch: walk bits
  int32_t* fmap;            // (segments, S, B) scratch: segment maps
  int S, k, t_actual, B;
  int vec, chunk, seg_len, segments;  // the plan (traceback_plan.h)
  int steps;                // t_actual - 1: the steps the segments walk
};

__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src,
                                               int size, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage steps [t0, t0 + len) of the block's rows [b0, b0 + kTbRows) into
// `buf`, laid out [step][state][row], by copy thread ct of nct: pieces of
// `vec` bytes, rows past B read as 0.
__device__ void stage_decisions(const TbParams& p, unsigned char* buf,
                                int t0, int len, int b0, int ct, int nct) {
  const int lg = __ffs(psk::kTbRows / p.vec) - 1;   // copies a row: 2^lg
  const int total = (len * p.S) << lg;
  for (int e = ct; e < total; e += nct) {
    const int ts = e >> lg;                 // (step - t0) * S + state
    const int row = b0 + (e - (ts << lg)) * p.vec;
    const int n = min(max(p.B - row, 0), p.vec);
    const int8_t* src =
        n ? p.dec + ((size_t)t0 * p.S + ts) * p.B + row : p.dec;
    unsigned char* dst = buf + (size_t)ts * psk::kTbRows + (row - b0);
    if (p.vec == 1)
      *dst = n ? (unsigned char)*src : 0;
    else
      cp_async_bytes(dst, src, p.vec, n);
  }
}

// B4, pass 1: block (row group, segment) walks its segment of steps
// [s_lo, s_hi) back from every one of the S states, for each of its
// kTbRows rows: walker warp w, lane = row, takes the Q end states e = w +
// walk_warps * m.
// Each walk keeps its bits in a register word, stored once per 32 steps to
// `words` at (step / 32, e, row), and its state at s_lo to `fmap` at
// (segment, e, row).  The copy warps stage the segment's decisions in
// tiles of `chunk` steps, latest first, kTbBuffers tiles in a ring and
// three ahead of the walk, one barrier a tile; the walkers read only
// shared memory.
template <int Q>
__global__ void __launch_bounds__(32 * (psk::kTbWalkWarps +
                                        psk::kTbCopyWarps))
    viterbi_segments_kernel(const TbParams p) {
  extern __shared__ __align__(16) unsigned char tiles[];
  constexpr int rows = psk::kTbRows;
  const int S = p.S, chunk = p.chunk;
  const int groups = (p.B + rows - 1) / rows;
  const int b0 = (blockIdx.x % groups) * rows;
  const int seg = blockIdx.x / groups;
  const int s_lo = seg * p.seg_len;
  const int s_hi = min(s_lo + p.seg_len, p.steps);
  const int ntiles = (s_hi - s_lo + chunk - 1) / chunk;
  const size_t tile_bytes = (size_t)chunk * S * rows;
  const int walk_warps = psk::traceback_walk_warps(S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool walker = warp < walk_warps;
  const int ct = threadIdx.x - 32 * walk_warps;
  const int nct = 32 * psk::kTbCopyWarps;
  // Order i is the segment's tile ntiles - 1 - i.
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int t0 = s_lo + (ntiles - 1 - i) * chunk;
      stage_decisions(p, tiles + (i % psk::kTbBuffers) * tile_bytes, t0,
                      min(chunk, s_hi - t0), b0, ct, nct);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (!walker)
    for (int i = 0; i < psk::kTbBuffers - 1; ++i) issue(i);

  const int b = b0 + lane;
  const bool live = walker && b < p.B;
  int st[Q];
  uint32_t acc[Q];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    st[m] = warp + walk_warps * m;
    acc[m] = 0;
  }
  for (int i = 0; i < ntiles; ++i) {
    if (!walker) cp_async_wait<psk::kTbBuffers - 2>();
    __syncthreads();  // order i staged; order i-1's buffer free
    if (!walker) {
      issue(i + psk::kTbBuffers - 1);
      continue;
    }
    const int t0 = s_lo + (ntiles - 1 - i) * chunk;
    const unsigned char* tb =
        tiles + (i % psk::kTbBuffers) * tile_bytes + lane;
    for (int tt = min(chunk, s_hi - t0) - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const unsigned char* step = tb + (size_t)tt * S * rows;
#pragma unroll
      for (int m = 0; m < Q; ++m) {
        const int d = step[st[m] * rows] != 0;
        acc[m] |= (uint32_t)((st[m] >> (p.k - 2)) & 1) << (t & 31);
        st[m] = ((st[m] << 1) & (S - 1)) | d;
      }
      if ((t & 31) == 0) {
        if (live)
#pragma unroll
          for (int m = 0; m < Q; ++m)
            p.words[((size_t)(t >> 5) * S + warp + walk_warps * m) * p.B + b] =
                acc[m];
#pragma unroll
        for (int m = 0; m < Q; ++m) acc[m] = 0;
      }
    }
  }
  if (live)
#pragma unroll
    for (int m = 0; m < Q; ++m)
      p.fmap[((size_t)seg * S + warp + walk_warps * m) * p.B + b] = st[m];
  if (!walker) cp_async_wait<0>();
}

// B4, pass 2: per row, the last step from the start state as the Pallas
// kernel takes it (the bit from the raw int32, an arithmetic shift;
// decision 0 when the start lies outside [0, S)), then the segments' maps
// from the last segment down give the state entering each segment, and
// every 32-step word of the walk from that state becomes 32 bit rows.
// Block: 32 rows by kTbResolveWarps warps.
__global__ void __launch_bounds__(32 * psk::kTbResolveWarps)
    viterbi_resolve_kernel(const TbParams p) {
  __shared__ int enter[psk::kTbMaxSegments][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const bool live = b < p.B;
  const int S = p.S;
  if (warp == 0) {
    const int raw = live ? p.start[b] : 0;
    const bool outside = raw < 0 || raw >= S;
    const int t = p.t_actual - 1;
    if (live) p.bits[(size_t)t * p.B + b] = (int8_t)((raw >> (p.k - 2)) & 1);
    const int d = (live && !outside)
                      ? p.dec[((size_t)t * S + raw) * p.B + b] != 0
                      : 0;
    int e = (int)(((unsigned)raw << 1) & (unsigned)(S - 1)) | d;
    for (int seg = p.segments - 1; seg >= 0; --seg) {
      enter[seg][lane] = e;
      e = live ? p.fmap[((size_t)seg * S + e) * p.B + b] : 0;
    }
  }
  __syncthreads();
  if (!live) return;
  const int nwords = (p.steps + 31) / 32;
  for (int w = warp; w < nwords; w += psk::kTbResolveWarps) {
    const int e = enter[(32 * w) / p.seg_len][lane];
    const uint32_t word = p.words[((size_t)w * S + e) * p.B + b];
    const int t_end = min(32 * w + 32, p.steps);
    for (int t = 32 * w; t < t_end; ++t)
      p.bits[(size_t)t * p.B + b] = (int8_t)((word >> (t & 31)) & 1);
  }
}

template <int N, bool kFused>
int launch_q(const Params& p, const Plan& pl, cudaStream_t st) {
  const int threads = pl.threads;
  switch (p.S / pl.lanes) {
    case 2:
      viterbi_warp_kernel<2, N, kFused><<<pl.grid, threads, pl.smem, st>>>(
          p, pl);
      break;
    case 4:
      viterbi_warp_kernel<4, N, kFused><<<pl.grid, threads, pl.smem, st>>>(
          p, pl);
      break;
    case 8:
      viterbi_warp_kernel<8, N, kFused><<<pl.grid, threads, pl.smem, st>>>(
          p, pl);
      break;
    default:
      viterbi_warp_kernel<16, N, kFused><<<pl.grid, threads, pl.smem, st>>>(
          p, pl);
  }
  return (int)cudaGetLastError();
}

int launch_acs(bool fused, const Params& p, void* stream) {
  if (bad_code(p.n, p.S, p.k) || p.t_actual < 0 || p.t_actual > p.T_pad)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  const int rc = make_plan(fused, p.S, p.n, p.t_actual, p.B, &pl);
  if (rc != 0) return rc;
  if (p.B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // n = 2 (every preset, punctured or not) keeps its signs as floats.
  if (p.n == 2)
    return fused ? launch_q<2, true>(p, pl, st) : launch_q<2, false>(p, pl, st);
  return fused ? launch_q<0, true>(p, pl, st) : launch_q<0, false>(p, pl, st);
}

}  // namespace

// The launch plan of B2 (fused 1) or B3 (fused 0) for S states, n outputs,
// t steps and B rows: out[0..7] = lanes a row, rows a warp, ACS warps,
// rows a block, chunk, shared-memory bytes, grid, threads a block.
// Returns 0, or an error code for a launch the kernels refuse (the same
// rule the launches apply).
extern "C" int psk_viterbi_plan(int fused, int S, int n, int t, int B,
                                int32_t* out) {
  Plan pl;
  const int rc = make_plan(fused != 0, S, n, t, B, &pl);
  if (rc != 0) return rc;
  const int v[8] = {pl.lanes, pl.rows_per_warp, pl.warps, pl.rows,
                    pl.chunk, pl.smem, pl.grid, pl.threads};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// B2.  llr (n, T_pad, B), pm0 (S, B), exp (2S, n) -> bits (T_pad, B), rows
// [0, t_actual) written.  Launches on `stream`; returns cudaGetLastError()
// after the launch (0 = launched), or an error code for arguments the
// kernel does not take (a trellis over its envelope included).
extern "C" int psk_viterbi_fused(const float* llr, const float* pm0,
                                 const float* exp, int8_t* bits, int n, int S,
                                 int k, int T_pad, int t_actual, int B,
                                 int terminate, void* stream) {
  Params p = {llr, pm0, exp, nullptr, nullptr, bits,
              n, S, k, T_pad, t_actual, B, terminate};
  return launch_acs(true, p, stream);
}

// B3.  llr (n, T_pad, B), pm0 (S, B), exp (2S, n) -> decisions (T_pad, S,
// B) int8, rows [0, t_actual) written, and the final metrics (S, B).
extern "C" int psk_viterbi_acs(const float* llr, const float* pm0,
                               const float* exp, int8_t* dec, float* pm_out,
                               int n, int S, int k, int T_pad, int t_actual,
                               int B, void* stream) {
  Params p = {llr, pm0, exp, dec, pm_out, nullptr,
              n, S, k, T_pad, t_actual, B, 0};
  return launch_acs(false, p, stream);
}

// B4.  decisions (T_pad, S, B) int8 (nonzero = 1), start (B,) int32 ->
// bits (T_pad, B), rows [0, t_actual) written; words ((t_actual + 30) /
// 32, S, B) uint32 and fmap (segments, S, B) int32 are scratch.  A start
// outside [0, S) gives its first bit from the raw value and reads decision
// 0 there, as the Pallas kernel does.  (vec, chunk, seg_len, segments,
// smem, grid, threads) is the plan of
// viterbi_kernel.traceback_plan, checked by traceback_plan_error; returns
// cudaErrorInvalidValue for a plan or arguments the kernels do not take,
// else cudaGetLastError() after the launches (the segment pass, when
// there are segments, then the resolve pass).
extern "C" int psk_viterbi_traceback(const int8_t* dec, const int32_t* start,
                                     int8_t* bits, uint32_t* words,
                                     int32_t* fmap, int S, int k,
                                     int t_actual, int B, int vec,
                                     int chunk, int seg_len, int segments,
                                     int smem, int grid, int threads,
                                     void* stream) {
  if (bad_code(1, S, k)
      || psk::traceback_plan_error(S, t_actual, B, vec, chunk, seg_len,
                                   segments, smem, grid, threads))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || t_actual == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TbParams p = {dec, start, bits, words, fmap, S, k, t_actual, B,
                      vec, chunk, seg_len, segments, t_actual - 1};
  if (segments > 0) {
    const int q = S / psk::traceback_walk_warps(S);
    const void* kern =
        q == 1    ? (const void*)viterbi_segments_kernel<1>
        : q == 2  ? (const void*)viterbi_segments_kernel<2>
        : q == 4  ? (const void*)viterbi_segments_kernel<4>
        : q == 8  ? (const void*)viterbi_segments_kernel<8>
        : q == 16 ? (const void*)viterbi_segments_kernel<16>
                  : (const void*)viterbi_segments_kernel<32>;
    if (smem > kSmemLimit) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    void* args[] = {const_cast<TbParams*>(&p)};
    const cudaError_t e =
        cudaLaunchKernel(kern, grid, threads, args, smem, st);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_resolve_kernel<<<(B + 31) / 32, 32 * psk::kTbResolveWarps, 0,
                           st>>>(p);
  return (int)cudaGetLastError();
}
