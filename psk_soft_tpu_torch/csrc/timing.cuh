// The C2 timing stage shared by kernels B1 (demod_full.cu) and B5
// (frontend.cu): reading row r of the [window | block] planes through two
// pointers, per-sample energy, and the first-max rule of the argmax.
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

}  // namespace psk
