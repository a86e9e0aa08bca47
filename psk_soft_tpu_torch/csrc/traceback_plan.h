// The launch plan of kernel B4 (viterbi_traceback) as the kernels take it.
//
// The plan is computed in Python (ops/cuda/viterbi_kernel.traceback_plan)
// and passed to psk_viterbi_traceback, which only checks it here: every
// condition the kernels' memory accesses and register arrays rely on.
// Plain C++ with no CUDA, so the same check also builds with a host
// compiler (define PSK_TRACEBACK_PLAN_ONLY for a library that exports
// nothing else; the CPU tests build it that way).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PSK_HD __host__ __device__
#else
#define PSK_HD
#endif

namespace psk {

constexpr int kTbRows = 32;          // decode rows a segment block
constexpr int kTbWalkWarps = 16;     // walker warps a block, at most
constexpr int kTbCopyWarps = 3;      // warps that stage the decision tiles
constexpr int kTbBuffers = 4;        // tiles in shared memory, 3 ahead
constexpr int kTbMaxSegments = 32;   // segments of a walk
constexpr int kTbResolveWarps = 8;   // pass 2: warps a block of 32 rows
constexpr int kTbMaxSmem = 232448;   // an H100 block's opt-in maximum

// Walker warps of a segment block: min(S, kTbWalkWarps), each a share of
// the S end states; S / walker warps walks a thread.
PSK_HD inline int traceback_walk_warps(int S) {
  return S < kTbWalkWarps ? S : kTbWalkWarps;
}

// 0 when (vec, chunk, seg_len, segments, smem, grid, threads) is a plan
// the kernels take for S states, t_actual steps and B decode rows; 1
// otherwise.  vec: bytes a copy moves (16 or 4 by cp.async, 1 by a load
// and a store; B a multiple of it); chunk: Tc steps a staged tile;
// seg_len: steps a segment (a multiple of 32), segments covering the
// t_actual - 1 steps before the last; smem: kTbBuffers tiles of (Tc, S,
// kTbRows) bytes; grid: row groups x segments; threads: the walker and
// copy warps.
inline int traceback_plan_error(int S, int t_actual, int B, int vec,
                                int chunk, int seg_len, int segments,
                                int smem, int grid, int threads) {
  if (S < 2 || S > 512 || (S & (S - 1)) || t_actual < 0 || B < 0) return 1;
  if ((vec != 1 && vec != 4 && vec != 16) || B % vec) return 1;
  const int walk_warps = traceback_walk_warps(S);
  const int steps = t_actual > 0 ? t_actual - 1 : 0;
  if (chunk < 1 || seg_len < 32 || seg_len % 32
      || segments != (steps + seg_len - 1) / seg_len
      || segments > kTbMaxSegments)
    return 1;
  if ((int64_t)smem != (int64_t)kTbBuffers * chunk * S * kTbRows
      || smem > kTbMaxSmem)
    return 1;
  if (grid != (B + kTbRows - 1) / kTbRows * segments) return 1;
  if (threads != 32 * (walk_warps + kTbCopyWarps)) return 1;
  return 0;
}

}  // namespace psk

#ifdef PSK_TRACEBACK_PLAN_ONLY
extern "C" int psk_traceback_plan_error(int S, int t_actual, int B, int vec,
                                        int chunk, int seg_len, int segments,
                                        int smem, int grid, int threads) {
  return psk::traceback_plan_error(S, t_actual, B, vec, chunk, seg_len,
                                   segments, smem, grid, threads);
}
#endif
