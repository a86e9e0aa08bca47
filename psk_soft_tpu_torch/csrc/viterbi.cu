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
// The signs are +/-1, so every product is exact and an FMA contraction
// rounds exactly as a multiply then an add: -fmad=false is not needed.
// The metrics are re-zeroed lazily: a step stores the new metrics as they
// are and the next step subtracts state 0's entry when it reads them,
// which is the same float subtraction the Pallas kernel does at the end
// of the step.  Traceback (ops/fec._make_back): the bit of step t is
// (s >> (K-2)) & 1, then s = ((s << 1) & (S-1)) | dec[t][s]; the start is
// state 0 (terminate) or the first maximum of the final metrics.
//
// Design (first version: simple and right).  A thread block holds
// R = NT / S decode rows with one thread per (row, state), NT =
// max(S, 256) threads, thread id = state * R + row.  The metrics
// ping-pong between two NT-float arrays in shared memory, one
// __syncthreads per step.  B2 packs each step's decisions with
// __ballot_sync into shared memory (one bit per thread and step, NT/8
// bytes a step), then one thread per row walks the traceback there.  B3
// writes each decision as an int8 to (T_pad, S, B).  B4 runs one thread
// per row, a chain of dependent loads through the decision plane.
//
// What bounds them on an H100.  B2 at the chain shape (K7, n 2, 64 steps,
// 6144 rows) moves 5 MB (1.5 us at 3.35 TB/s) and does about 11 operations
// per (step, row, state), 277 M in all (4 us at the 67 TFLOP/s of float32
// outside the tensor cores): operations bound it.  The ACS is a serial
// chain over time with one block-wide barrier per step, so the kernel is
// bound in practice by that barrier and shared-memory latency; enough
// independent rows (1536 blocks at the chain shape) keep the SMs busy.
// B3 is bound by the int8 decision plane it writes (T * S bytes a row);
// B4 by the latency of its dependent loads, one per step.
//
// The fused path needs t_actual * NT / 8 + 8 * NT bytes of shared memory
// per block and takes at most kFusedSmem of it, the default limit (no
// opt-in); longer trellises go to B3 + B4 (the Python dispatch applies the
// same rule, psk_soft_tpu_torch/ops/cuda/viterbi_kernel.fused_smem_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8;            // code outputs per trellis step
constexpr int kMinThreads = 256;    // threads per block when S <= 256
constexpr int kMaxK = 10;           // 512 states
constexpr int kFusedSmem = 48 * 1024;

inline int threads_for(int S) { return S > kMinThreads ? S : kMinThreads; }

struct Params {
  const float* llr;     // (n, T_pad, B)
  const float* pm0;     // (S, B)
  const float* exp;     // (2S, n) butterfly signs
  int8_t* dec;          // B3: (T_pad, S, B) decisions
  float* pm_out;        // B3: (S, B) final metrics
  int8_t* bits;         // B2: (T_pad, B) decoded bits
  int n, S, k, T_pad, t_actual, B, terminate;
};

template <bool kFused>
__global__ void viterbi_acs_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NT = blockDim.x;
  const int S = p.S;
  const int R = NT / S;
  const int tid = threadIdx.x;
  const int s = tid / R;
  const int r = tid - s * R;
  const int b = blockIdx.x * R + r;
  const bool valid = b < p.B;
  float* buf0 = smem;
  float* buf1 = smem + NT;
  uint32_t* decw = reinterpret_cast<uint32_t*>(smem + 2 * NT);
  const int words = NT / 32;            // decision words per step (B2)

  const int half = S / 2;
  const int a = s / half;
  const int j = s - a * half;
  const int q0 = (2 * j) * R + r;       // predecessor 2j of this row
  const int q1 = q0 + R;                // predecessor 2j + 1
  float e0[kMaxN], e1[kMaxN];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    e0[i] = i < p.n ? p.exp[(a * S + 2 * j) * p.n + i] : 0.f;
    e1[i] = i < p.n ? p.exp[(a * S + 2 * j + 1) * p.n + i] : 0.f;
  }

  buf0[tid] = valid ? p.pm0[(size_t)s * p.B + b] : 0.f;
  __syncthreads();
  float mine = buf0[tid];               // the metrics if t_actual == 0
  for (int t = 0; t < p.t_actual; ++t) {
    const float* cur = (t & 1) ? buf1 : buf0;
    float* nxt = (t & 1) ? buf0 : buf1;
    const float z = t == 0 ? 0.f : cur[r];          // state 0 of the row
    const float pa = cur[q0] - z;
    const float pb = cur[q1] - z;
    float bm0 = 0.f, bm1 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i) {
      if (i < p.n) {
        const float l =
            valid ? p.llr[((size_t)i * p.T_pad + t) * p.B + b] : 0.f;
        if (i == 0) {
          bm0 = e0[0] * l;
          bm1 = e1[0] * l;
        } else {
          bm0 = bm0 + e0[i] * l;
          bm1 = bm1 + e1[i] * l;
        }
      }
    }
    const float c0 = pa + bm0;
    const float c1 = pb + bm1;
    const bool d = c1 > c0;
    nxt[tid] = d ? c1 : c0;
    if (kFused) {
      const uint32_t w = __ballot_sync(0xffffffffu, d);
      if ((tid & 31) == 0) decw[t * words + (tid >> 5)] = w;
    } else if (valid) {
      p.dec[((size_t)t * S + s) * p.B + b] = (int8_t)d;
    }
    __syncthreads();
  }
  if (p.t_actual > 0) {
    const float* last = (p.t_actual & 1) ? buf1 : buf0;
    mine = last[tid] - last[r];
  }
  if (!kFused) {
    if (valid) p.pm_out[(size_t)s * p.B + b] = mine;
    return;
  }

  // Final metrics where the traceback thread of the row can read them:
  // the buffer the last step read from is free again.
  float* fin = (p.t_actual & 1) ? buf0 : buf1;
  fin[tid] = mine;
  __syncthreads();
  if (s != 0 || !valid) return;
  int st = 0;
  if (!p.terminate) {                   // first maximum, as jnp.argmax
    float best = fin[r];
    for (int q = 1; q < S; ++q) {
      const float v = fin[q * R + r];
      if (v > best) {
        best = v;
        st = q;
      }
    }
  }
  for (int t = p.t_actual - 1; t >= 0; --t) {
    p.bits[(size_t)t * p.B + b] = (int8_t)((st >> (p.k - 2)) & 1);
    const int q = st * R + r;
    const uint32_t d = (decw[t * words + (q >> 5)] >> (q & 31)) & 1u;
    st = ((st << 1) & (S - 1)) | (int)d;
  }
}

__global__ void viterbi_traceback_kernel(const int8_t* __restrict__ dec,
                                         const int32_t* __restrict__ start,
                                         int8_t* __restrict__ bits, int S,
                                         int k, int t_actual, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int st = start[b] & (S - 1);
  for (int t = t_actual - 1; t >= 0; --t) {
    bits[(size_t)t * B + b] = (int8_t)((st >> (k - 2)) & 1);
    const int d = dec[((size_t)t * S + st) * B + b] != 0;
    st = ((st << 1) & (S - 1)) | d;
  }
}

bool bad_code(int n, int S, int k) {
  return n < 1 || n > kMaxN || k < 2 || k > kMaxK || S != (1 << (k - 1));
}

int launch_acs(bool fused, const Params& p, void* stream) {
  if (bad_code(p.n, p.S, p.k) || p.t_actual < 0 || p.t_actual > p.T_pad)
    return (int)cudaErrorInvalidValue;
  const int nt = threads_for(p.S);
  const int rows = nt / p.S;
  size_t smem = (size_t)2 * nt * sizeof(float);
  if (fused) smem += (size_t)p.t_actual * (nt / 32) * sizeof(uint32_t);
  if (smem > (size_t)kFusedSmem) return (int)cudaErrorInvalidValue;
  if (p.B == 0) return 0;
  const int blocks = (p.B + rows - 1) / rows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fused)
    viterbi_acs_kernel<true><<<blocks, nt, smem, st>>>(p);
  else
    viterbi_acs_kernel<false><<<blocks, nt, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// B2.  llr (n, T_pad, B), pm0 (S, B), exp (2S, n) -> bits (T_pad, B), rows
// [0, t_actual) written.  Launches on `stream`; returns cudaGetLastError()
// after the launch (0 = launched), or an error code for arguments the
// kernel does not take (the shared-memory budget included).
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

// B4.  decisions (T_pad, S, B) int8 (nonzero = 1), start (B,) int32 (taken
// mod S) -> bits (T_pad, B), rows [0, t_actual) written.
extern "C" int psk_viterbi_traceback(const int8_t* dec, const int32_t* start,
                                     int8_t* bits, int S, int k, int t_actual,
                                     int B, void* stream) {
  if (bad_code(1, S, k) || t_actual < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int threads = 128;
  viterbi_traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      dec, start, bits, S, k, t_actual, B);
  return (int)cudaGetLastError();
}
