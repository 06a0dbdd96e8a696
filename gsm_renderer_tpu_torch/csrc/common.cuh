// Shared device helpers of the gsm_renderer_tpu_torch kernels.
//
// The kernels repeat the JAX reference's float32 arithmetic operation for
// operation; they are compiled with --fmad=false so a*b+c stays two rounded
// operations.  jnp.maximum / jnp.minimum / jnp.clip propagate NaN, which
// fmaxf / fminf do not, hence jmax / jmin / jclip.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GSM_CULLED_BIT 0x40000000u
#define GSM_MASKED_BIT 0x80000000u
#define GSM_SENTINEL 0xFFFFFFFFu
#define GSM_MASK_W 8
#define GSM_MASK_H 4

extern "C" const char* gsm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// IEEE float16 bits (low 16 bits) -> float32, subnormals flushed to zero
// (expand.py::_f16_bits_to_f32, blend.py::_f16); not __half2float, which
// keeps subnormals.
__device__ __forceinline__ float f16_bits_to_f32(uint32_t bits) {
  const uint32_t b = bits & 0xFFFFu;
  const uint32_t sign = (b >> 15) << 31;
  const uint32_t e = (b >> 10) & 0x1Fu;
  const uint32_t m = b & 0x3FFu;
  const uint32_t f = sign | ((e + 112u) << 23) | (m << 13);
  return e == 0 ? 0.0f : __uint_as_float(f);
}

// The record word rows of an entry table (up to 8: left eye w0..w3, right
// eye w0..w3), passed to a kernel by value.
struct WordPtrs {
  const int32_t* w[8];
};

// WordPtrs from a host array of n_words device pointers (the rest null).
static inline WordPtrs load_words(const void* const* words, int n_words) {
  WordPtrs W;
  for (int k = 0; k < 8; ++k) {
    W.w[k] = k < n_words ? static_cast<const int32_t*>(words[k]) : nullptr;
  }
  return W;
}

// float(u8 field) * (1/255): the quantized opacity / color decode.
__device__ __forceinline__ float u8f(uint32_t w, int shift, float inv255) {
  return static_cast<float>(static_cast<int>((w >> shift) & 0xFFu)) * inv255;
}

// Decoded conic of a quantized record (expand.py::_conic_from_words).
struct Conic {
  float mx, my, ca, cb, cc;
};

__device__ __forceinline__ Conic decode_conic(uint32_t w0, uint32_t w1,
                                              uint32_t w2, float theta_unit) {
  Conic k;
  k.mx = f16_bits_to_f32(w0);
  k.my = f16_bits_to_f32(w0 >> 16);
  const float theta =
      static_cast<float>(static_cast<int>(w1 & 0xFFFFu)) * theta_unit;
  const float s1 = jmax(f16_bits_to_f32(w1 >> 16), 1e-4f);
  const float s2 = jmax(f16_bits_to_f32(w2), 1e-4f);
  const float c = cosf(theta);
  const float s = sinf(theta);
  const float iv1 = 1.0f / (s1 * s1);
  const float iv2 = 1.0f / (s2 * s2);
  k.ca = c * c * iv1 + s * s * iv2;
  k.cb = c * s * (iv1 - iv2);
  k.cc = s * s * iv1 + c * c * iv2;
  return k;
}

// minQuadRect of the conic over the mean-centred rect [xmin, xmax] x
// [ymin, ymax] (expand.py::_d2min_rect / _record_d2min).
__device__ __forceinline__ float d2min_rect(const Conic& k, float xmin,
                                            float xmax, float ymin,
                                            float ymax) {
  const bool inside = (xmin <= 0.0f) && (0.0f <= xmax) && (ymin <= 0.0f) &&
                      (0.0f <= ymax);
  const float inv_a = 1.0f / jmax(k.ca, 1e-20f);
  const float inv_c = 1.0f / jmax(k.cc, 1e-20f);
  const float ca = k.ca, cb = k.cb, cc = k.cc;
#define GSM_QUAD(x, y) (ca * (x) * (x) + 2.0f * cb * (x) * (y) + cc * (y) * (y))
  const float y1 = jclip(-(cb * inv_c) * xmin, ymin, ymax);
  const float q1 = GSM_QUAD(xmin, y1);
  const float y2 = jclip(-(cb * inv_c) * xmax, ymin, ymax);
  const float q2 = GSM_QUAD(xmax, y2);
  const float x3 = jclip(-(cb * inv_a) * ymin, xmin, xmax);
  const float q3 = GSM_QUAD(x3, ymin);
  const float x4 = jclip(-(cb * inv_a) * ymax, xmin, xmax);
  const float q4 = GSM_QUAD(x4, ymax);
#undef GSM_QUAD
  return inside ? 0.0f : jmin(jmin(q1, q2), jmin(q3, q4));
}

// d2 alpha cutoff of a quantized opacity: -1 below tau.
__device__ __forceinline__ float d2_cutoff(float op, float tau) {
  return op < tau ? -1.0f : -2.0f * logf(tau / jmax(op, 1e-30f));
}
