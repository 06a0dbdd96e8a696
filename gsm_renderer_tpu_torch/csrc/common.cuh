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

// A tile side the kernels take: 1 to 4096 pixels (kernels/expand.py
// MAX_TILE_SIDE).  A tile then holds at most 2^24 pixels, so every in-tile
// pixel offset and every tile bound (a tile index of at most 1023, the rect
// word's 10-bit fields, times the side) is an integer below 2^24, exact in
// float32, and every pixel index fits int32; the projection's tile rect
// multiplies by the float32 reciprocal of the side, as the JAX reference's
// jitted division by a constant does.
static inline bool tile_side_ok(int side) {
  return side >= 1 && side <= 4096;
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

// What minQuadRect reads of a conic, with the per-conic terms computed
// once: ca, 2 cb, cc, cb / cc and cb / ca (as cb * (1 / max(c, 1e-20))),
// for callers that test one record against many rects (d2min_quad).
struct QuadRect {
  float ca, cb2, cc, cb_ic, cb_ia;
};

__device__ __forceinline__ QuadRect quad_rect(const Conic& k) {
  const float inv_a = 1.0f / jmax(k.ca, 1e-20f);
  const float inv_c = 1.0f / jmax(k.cc, 1e-20f);
  return QuadRect{k.ca, 2.0f * k.cb, k.cc, k.cb * inv_c, k.cb * inv_a};
}

// max / min that return NaN when either input is NaN: one instruction
// (max.NaN, min.NaN, sm_80+) where jmax / jmin take three.  They differ
// from jmax / jmin only in which zero of two opposite-signed zeros and which
// NaN they return.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// d2min_rect of a QuadRect, the same operations in the same order, with
// max_nan / min_nan for jmax / jmin.  The result is d2min_rect's, up to
// the sign of a zero and the bits of a NaN, which no comparison sees: a
// clipped coordinate of either sign squares, and multiplies a non-zero
// coordinate, to the same quadratic form; the form's terms of a zero
// coordinate are zeros whose sum is +0 either way; and a NaN anywhere gives
// NaN in both.  So a test d2 <= cutoff passes for both or neither.
__device__ __forceinline__ float d2min_quad(const QuadRect& q, float xmin,
                                            float xmax, float ymin,
                                            float ymax) {
  const bool inside = (xmin <= 0.0f) && (0.0f <= xmax) && (ymin <= 0.0f) &&
                      (0.0f <= ymax);
#define GSM_QUAD(x, y) \
  (q.ca * (x) * (x) + q.cb2 * (x) * (y) + q.cc * (y) * (y))
#define GSM_CLIP(x, lo, hi) min_nan(max_nan(x, lo), hi)
  const float y1 = GSM_CLIP(-q.cb_ic * xmin, ymin, ymax);
  const float q1 = GSM_QUAD(xmin, y1);
  const float y2 = GSM_CLIP(-q.cb_ic * xmax, ymin, ymax);
  const float q2 = GSM_QUAD(xmax, y2);
  const float x3 = GSM_CLIP(-q.cb_ia * ymin, xmin, xmax);
  const float q3 = GSM_QUAD(x3, ymin);
  const float x4 = GSM_CLIP(-q.cb_ia * ymax, xmin, xmax);
  const float q4 = GSM_QUAD(x4, ymax);
#undef GSM_CLIP
#undef GSM_QUAD
  return inside ? 0.0f : min_nan(min_nan(q1, q2), min_nan(q3, q4));
}

// d2 alpha cutoff of a quantized opacity: -1 below tau.
__device__ __forceinline__ float d2_cutoff(float op, float tau) {
  return op < tau ? -1.0f : -2.0f * logf(tau / jmax(op, 1e-30f));
}
