// Host packet assembly for the bank engine's four output ports.
//
// Kernel B1 writes time-major (S, C) planes: S symbols of C channels, the
// channel index fastest.  runtime/engine_bank.BankAssembler.assemble_tm
// fetches them to the host and turns them into the reference component's
// channel-major payloads:
//   soft         re/im planes (float32, or int8 dequantized as
//                float(q) * inv with inv the float32 of 1/scale) to an
//                (S, C) complex64 interleave, handed out as its (C, S)
//                transposed view;
//   bits         packed LSB-first planes (int8 or int32) to int16 (C, S*nb),
//                bit b of symbol s at column s*nb + b;
//   phase        float32 (S, C) to a contiguous float32 (C, S);
//   sampleIndex  int8 or int32 (S, C) to a contiguous int16 (C, S), wrapped
//                to 16 bits as a numpy astype does.
// Each entry point reads its planes once and writes its payload once into
// memory the caller allocated; the transposes go in 64 x 64 tiles, so a
// tile's strided reads revisit the same 64 rows of cache lines.
// Single-threaded; the planes and payloads are C-contiguous and never
// alias.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared (runtime/native_assemble.py does
// it at first use); plain C interface for ctypes.

#include <algorithm>
#include <cstdint>

namespace {

constexpr int64_t kTile = 64;

// dst[c, s] = f(src[s, c]) for an (S, C) src and a (C, S) dst.
template <typename In, typename Out, typename F>
void transpose(const In* src, int64_t S, int64_t C, Out* dst, F f) {
  for (int64_t c0 = 0; c0 < C; c0 += kTile) {
    const int64_t c1 = std::min(C, c0 + kTile);
    for (int64_t s0 = 0; s0 < S; s0 += kTile) {
      const int64_t s1 = std::min(S, s0 + kTile);
      for (int64_t c = c0; c < c1; ++c) {
        const In* in = src + s0 * C + c;
        Out* out = dst + c * S + s0;
        for (int64_t s = s0; s < s1; ++s, in += C) *out++ = f(*in);
      }
    }
  }
}

// The bit unpack, with the width fixed at compile time where NB > 0.
template <int NB, typename T>
void unpack(const T* src, int64_t S, int64_t C, int nb, int16_t* dst) {
  const int n = NB > 0 ? NB : nb;
  const int64_t row = S * n;
  for (int64_t c0 = 0; c0 < C; c0 += kTile) {
    const int64_t c1 = std::min(C, c0 + kTile);
    for (int64_t s0 = 0; s0 < S; s0 += kTile) {
      const int64_t s1 = std::min(S, s0 + kTile);
      for (int64_t c = c0; c < c1; ++c) {
        const T* in = src + s0 * C + c;
        int16_t* out = dst + c * row + s0 * n;
        for (int64_t s = s0; s < s1; ++s, in += C) {
          // Sign-extended, so a bit above the plane's width reads the sign
          // bit, as numpy's shift of the widened value does.
          const uint32_t v = static_cast<uint32_t>(static_cast<int32_t>(*in));
          for (int b = 0; b < n; ++b) *out++ = static_cast<int16_t>((v >> b) & 1u);
        }
      }
    }
  }
}

template <typename T>
void unpack_any(const T* src, int64_t S, int64_t C, int nb, int16_t* dst) {
  switch (nb) {
    case 1: unpack<1>(src, S, C, nb, dst); break;
    case 2: unpack<2>(src, S, C, nb, dst); break;
    case 3: unpack<3>(src, S, C, nb, dst); break;
    default: unpack<0>(src, S, C, nb, dst); break;
  }
}

template <typename T>
void index_to_i16(const T* src, int64_t S, int64_t C, int16_t* dst) {
  transpose(src, S, C, dst, [](T v) { return static_cast<int16_t>(v); });
}

}  // namespace

extern "C" {

// n = S * C elements of each plane into 2n floats of dst.
void psk_soft_f32(const float* re, const float* im, int64_t n, float* dst) {
  for (int64_t i = 0; i < n; ++i) {
    dst[2 * i] = re[i];
    dst[2 * i + 1] = im[i];
  }
}

void psk_soft_i8(const int8_t* re, const int8_t* im, int64_t n, float inv,
                 float* dst) {
  for (int64_t i = 0; i < n; ++i) {
    dst[2 * i] = static_cast<float>(re[i]) * inv;
    dst[2 * i + 1] = static_cast<float>(im[i]) * inv;
  }
}

void psk_bits_i8(const int8_t* src, int64_t S, int64_t C, int32_t nb,
                 int16_t* dst) {
  unpack_any(src, S, C, nb, dst);
}

void psk_bits_i32(const int32_t* src, int64_t S, int64_t C, int32_t nb,
                  int16_t* dst) {
  unpack_any(src, S, C, nb, dst);
}

void psk_phase(const float* src, int64_t S, int64_t C, float* dst) {
  transpose(src, S, C, dst, [](float v) { return v; });
}

void psk_index_i8(const int8_t* src, int64_t S, int64_t C, int16_t* dst) {
  index_to_i16(src, S, C, dst);
}

void psk_index_i32(const int32_t* src, int64_t S, int64_t C, int16_t* dst) {
  index_to_i16(src, S, C, dst);
}

}  // extern "C"
