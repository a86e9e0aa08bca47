// Deframing for the port's plane bank (runtime/native_bank.NativePlaneBank).
//
// Sample-interleaved multichannel frames (s0c0_re s0c0_im s0c1_re ...) are
// already time-major across channels, so turning n frames into n rows of
// the (T, C) re and im planes that kernel B1 reads is a stride-2 split:
// each frame's 2*C elements become one contiguous row of C in each plane.
// The bank owns the planes' memory (segments of its ring, page-locked once
// CUDA is up) and passes the rows to write; this file keeps no state.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared (runtime/native_bank.py does it
// at first use); plain C interface for ctypes.

#include <cstdint>

namespace {

template <typename T>
void split(const T* iq, int64_t n, int64_t C, T* re, T* im) {
  for (int64_t i = 0; i < n; ++i) {
    const T* src = iq + i * C * 2;
    T* dr = re + i * C;
    T* di = im + i * C;
    for (int64_t c = 0; c < C; ++c) {
      dr[c] = src[2 * c];
      di[c] = src[2 * c + 1];
    }
  }
}

}  // namespace

extern "C" {

// n frames of C complex64 samples from iq into n rows of C floats at re
// and at im.
void psk_split_f32(const float* iq, int64_t n, int64_t C, float* re,
                   float* im) {
  split(iq, n, C, re, im);
}

// The same for int16 I/Q pairs (the sc16 wire).
void psk_split_i16(const int16_t* iq, int64_t n, int64_t C, int16_t* re,
                   int16_t* im) {
  split(iq, n, C, re, im);
}

}  // extern "C"
