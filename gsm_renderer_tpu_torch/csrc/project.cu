// Kernel 1: project, cull, quantize and pack, one thread per gaussian.
//
// Replaces the Pallas kernel gsm_renderer_tpu/kernels/project.py::
// _project_kernel (called by project_and_cull_packed) together with its XLA
// theta epilogue (project.py:407-418): atan2 is folded in here.
//
// Arithmetic: formula for formula the JAX kernel (mathlib.py), in the same
// association order, with float32 constants from the host (ProjParams).  The
// f32 -> f16 record packing is the manual integer round-to-nearest-even of
// project.py::_f32_to_f16_bits (NaN -> 0x7E00, overflow -> inf), not
// __float2half_rn.
//
// Modes: tiles of tile_w x tile_h pixels in the tile rect (ProjInts::tile_w,
// ::tile_h, each 1 to 4096; the renderers use 16x16 and the Global
// renderer's 32x16; see tile_bounds for the rounding), and the 16-bit half-depth key (ProjInts::key16, the
// Pallas kernel's depth_key16: half_key16 of the record's f16 depth bits,
// 0xFFFFFFFF where culled, no KeyPlan) in place of the 32-bit depth word.
// The dual-eye kernel takes the same tiles and the 32-bit word.
//
// Bound on the H100: device memory.  Each gaussian reads 11 component floats
// plus 3 * n_coeffs SH floats (236 B at SH3) and writes 29 B, against a few
// hundred float operations, far below the card's ~20 flop/B balance point.
// The design keeps every plane coalesced (structure of arrays, thread i reads
// element i of each plane) and does everything in registers in one pass.
#include <cstring>

#include "common.cuh"

struct ProjParams {
  float view[16];
  float proj[16];
  float center[3];
  float near_plane, far_plane, half_w, half_h, alpha_threshold;
  float lim_x, lim_y, focal_x, focal_y, max_eig;
  float width, height, wm1, hm1;
  float ink_threshold, ink_af, ink_den;
  float tau, theta_scale, pi, inv255;
};

struct ProjInts {
  int n, tiles_x, tiles_y, sh_degree, srgb, has_plan, tile_w, key16, tile_h;
  uint32_t near_key, span;
};

__device__ __forceinline__ uint32_t f32_to_f16_bits(float v) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t sign = (bits >> 16) & 0x8000u;
  const uint32_t f = bits & 0x7FFFFFFFu;
  const bool is_nan = f > 0x7F800000u;
  const bool is_big = f >= 0x47800000u;
  const uint32_t big = is_nan ? 0x7E00u : 0x7C00u;
  const bool is_small = f < (113u << 23);
  const uint32_t sub = __float_as_uint(__uint_as_float(f) + 0.5f) - 0x3F000000u;
  const uint32_t mant_odd = (f >> 13) & 1u;
  const uint32_t rebias = (0u - (112u << 23)) + 0xFFFu;
  const uint32_t fn = f + rebias + mant_odd;
  uint32_t h = is_small ? sub : (fn >> 13);
  h = is_big ? big : h;
  return (sign | h) & 0xFFFFu;
}

// jnp.mod for float32 (lax.rem, then + divisor where the sign differs)
__device__ __forceinline__ float jmod(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) ? r + y : r;
}

__device__ __forceinline__ uint32_t quant_u8(float c) {
  return static_cast<uint32_t>(static_cast<int>(jclip(c * 255.0f, 0.0f, 255.0f)));
}

// ---------------------------------------------------------------------------
// Per-gaussian stages, shared by the mono and the stereo kernels.  Each is
// the formula chain of the named JAX mathlib function, operation for
// operation.
// ---------------------------------------------------------------------------

struct Cov3 {
  float s00, s01, s02, s11, s12, s22;
};

// build_covariance_3d_c: Sigma = R S S^T R^T (upper triangle).
__device__ __forceinline__ Cov3 covariance_3d(float sx, float sy, float sz,
                                              float qx, float qy, float qz,
                                              float qw) {
  const float inv_norm =
      1.0f / sqrtf(jmax(qx * qx + qy * qy + qz * qz + qw * qw, 1e-8f));
  const float x = qx * inv_norm, y = qy * inv_norm, z = qz * inv_norm,
              r = qw * inv_norm;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float rs00 = (1.0f - 2.0f * (yy + zz)) * sx;
  const float rs01 = 2.0f * (xy - r * z) * sy;
  const float rs02 = 2.0f * (xz + r * y) * sz;
  const float rs10 = 2.0f * (xy + r * z) * sx;
  const float rs11 = (1.0f - 2.0f * (xx + zz)) * sy;
  const float rs12 = 2.0f * (yz - r * x) * sz;
  const float rs20 = 2.0f * (xz - r * y) * sx;
  const float rs21 = 2.0f * (yz + r * x) * sy;
  const float rs22 = (1.0f - 2.0f * (xx + yy)) * sz;
  Cov3 c;
  c.s00 = rs00 * rs00 + rs01 * rs01 + rs02 * rs02;
  c.s01 = rs00 * rs10 + rs01 * rs11 + rs02 * rs12;
  c.s02 = rs00 * rs20 + rs01 * rs21 + rs02 * rs22;
  c.s11 = rs10 * rs10 + rs11 * rs11 + rs12 * rs12;
  c.s12 = rs10 * rs20 + rs11 * rs21 + rs12 * rs22;
  c.s22 = rs20 * rs20 + rs21 * rs21 + rs22 * rs22;
  return c;
}

// project_covariance_2d_c (EWA, 0.3 px low-pass) then
// stabilize_covariance_2d_c: the screen covariance (ca, cb, cd).
__device__ __forceinline__ void covariance_2d(const Cov3& S, float vx, float vy,
                                              float vz, const ProjParams& P,
                                              float* ca_out, float* cb_out,
                                              float* cd_out) {
  const float* V = P.view;
  const float abs_z = fabsf(vz);
  const float sign_z = vz >= 0.0f ? 1.0f : -1.0f;
  const float safe_abs_z = jmax(abs_z, 1e-4f);
  const float inv_z = 1.0f / safe_abs_z;
  const float inv_z2 = inv_z * inv_z;
  const float x_cl = jclip(vx * inv_z, -P.lim_x, P.lim_x) * safe_abs_z;
  const float y_cl = jclip(vy * inv_z, -P.lim_y, P.lim_y) * safe_abs_z;
  const float j00 = P.focal_x * inv_z;
  const float j11 = P.focal_y * inv_z;
  const float j02 = -P.focal_x * x_cl * sign_z * inv_z2;
  const float j12 = -P.focal_y * y_cl * sign_z * inv_z2;
  float t0[3], t1[3];
  for (int k = 0; k < 3; ++k) {
    t0[k] = j00 * V[k] + j02 * V[8 + k];
    t1[k] = j11 * V[4 + k] + j12 * V[8 + k];
  }
  const float sym[3][3] = {{S.s00, S.s01, S.s02},
                           {S.s01, S.s11, S.s12},
                           {S.s02, S.s12, S.s22}};
  float m0[3], m1[3];
  for (int k = 0; k < 3; ++k) {
    m0[k] = t0[0] * sym[0][k] + t0[1] * sym[1][k] + t0[2] * sym[2][k];
    m1[k] = t1[0] * sym[0][k] + t1[1] * sym[1][k] + t1[2] * sym[2][k];
  }
  float ca = m0[0] * t0[0] + m0[1] * t0[1] + m0[2] * t0[2] + 0.3f;
  float cb = m0[0] * t1[0] + m0[1] * t1[1] + m0[2] * t1[2];
  float cd = m1[0] * t1[0] + m1[1] * t1[1] + m1[2] * t1[2] + 0.3f;

  // stabilization
  const bool finite = isfinite(ca) && isfinite(cb) && isfinite(cd);
  float a = finite ? ca : 1.0f;
  const float b = finite ? cb : 0.0f;
  float d = finite ? cd : 1.0f;
  a = jmax(a, 1e-4f);
  d = jmax(d, 1e-4f);
  float det = a * d - b * b;
  det = isfinite(det) ? det : 0.0f;
  const float bump = det < 1e-8f ? (1e-8f - det) + 1e-4f : 0.0f;
  a = a + bump;
  d = d + bump;
  const float det2 = a * d - b * b;
  const float mid = 0.5f * (a + d);
  const float disc = jmax(mid * mid - det2, 0.0f);
  const float sqrt_disc = sqrtf(disc);
  float lam1 = mid + sqrt_disc;
  float lam2 = jmax(mid - sqrt_disc, 1e-4f);
  const bool use_b = fabsf(b) > 1e-8f;
  const float ex = use_b ? b : (a >= d ? 1.0f : 0.0f);
  const float ey = use_b ? lam1 - a : (a >= d ? 0.0f : 1.0f);
  const float vlen = sqrtf(ex * ex + ey * ey);
  const float inv = 1.0f / jmax(vlen, 1e-8f);
  const float v1x = ex * inv, v1y = ey * inv;
  const float v2x = v1y, v2y = -v1x;
  lam1 = jmin(lam1, P.max_eig);
  lam2 = jmax(lam2, lam1 / 65536.0f);
  const float oa = lam1 * v1x * v1x + lam2 * v2x * v2x;
  const float ob = lam1 * v1x * v1y + lam2 * v2x * v2y;
  const float od = lam1 * v1y * v1y + lam2 * v2y * v2y;
  *ca_out = finite ? oa : 1.0f;
  *cb_out = finite ? ob : 0.0f;
  *cd_out = finite ? od : 1.0f;
}

// covariance_to_theta_sigmas_c minus atan2: the unit major eigenvector and
// the sigmas; returns eig_ok.
__device__ __forceinline__ bool theta_sigmas(float ca, float cb, float cd,
                                             float* evx_out, float* evy_out,
                                             float* sigma1, float* sigma2) {
  const float a = jmax(ca, 1e-8f);
  const float d = jmax(cd, 1e-8f);
  const float b = cb;
  const bool finite = isfinite(a) && isfinite(b) && isfinite(d);
  const float det = a * d - b * b;
  const bool eig_ok = finite && isfinite(det) && (det > 0.0f);
  const float mid = 0.5f * (a + d);
  const float disc = jmax(mid * mid - det, 0.0f);
  const float sqrt_disc = sqrtf(disc);
  const float lam1 = jmax(mid + sqrt_disc, 1e-8f);
  const float lam2 = jmax(mid - sqrt_disc, 1e-8f);
  const bool use_b = fabsf(b) > 1e-8f;
  float evx = use_b ? b : (a >= d ? 1.0f : 0.0f);
  float evy = use_b ? lam1 - a : (a >= d ? 0.0f : 1.0f);
  const float vlen = sqrtf(evx * evx + evy * evy);
  *evx_out = evx / jmax(vlen, 1e-12f);
  *evy_out = evy / jmax(vlen, 1e-12f);
  *sigma1 = sqrtf(lam1);
  *sigma2 = sqrtf(lam2);
  return eig_ok && isfinite(*sigma1) && isfinite(*sigma2);
}

// compute_obb_extents_c: axis-aligned extents of the oriented 3-sigma box.
__device__ __forceinline__ void obb_extents(float ca, float cb, float cd,
                                            float* obb_x, float* obb_y) {
  const float det = ca * cd - cb * cb;
  const float mid = 0.5f * (ca + cd);
  const float disc = jmax(mid * mid - det, 1e-6f);
  const float sqrt_disc = sqrtf(disc);
  const float lam1 = mid + sqrt_disc;
  const float lam2 = jmax(mid - sqrt_disc, 1e-6f);
  const float e1 = 3.0f * sqrtf(jmax(lam1, 1e-6f));
  const float e2 = 3.0f * sqrtf(jmax(lam2, 1e-6f));
  const bool use_b = fabsf(cb) > 1e-6f;
  float ox = use_b ? cb : (ca >= cd ? 1.0f : 0.0f);
  float oy = use_b ? lam1 - ca : (ca >= cd ? 0.0f : 1.0f);
  const float vlen = jmax(sqrtf(ox * ox + oy * oy), 1e-6f);
  ox = ox / vlen;
  oy = oy / vlen;
  *obb_x = fabsf(ox) * e1 + fabsf(oy) * e2;
  *obb_y = fabsf(oy) * e1 + fabsf(ox) * e2;
}

// cull_by_total_ink with the depth-adaptive threshold.
__device__ __forceinline__ bool ink_culled(float opacity, float det2d,
                                           float depth, const ProjParams& P) {
  if (!(P.ink_threshold > 0.0f)) return false;
  const float total_ink = opacity * 6.283185f * sqrtf(jmax(det2d, 1e-12f));
  const float t = jclip((P.ink_af - depth) / P.ink_den, 0.0f, 1.0f);
  return total_ink < (1.0f - t * t) * P.ink_threshold;
}

// SH colour seen from the camera centre (cx, cy, cz), +0.5, clamped at 0,
// optionally sRGB-decoded.  SH is the degree (0..3), a template argument so
// that the basis and coefficient loops unroll into registers.
template <int SH>
__device__ __forceinline__ void sh_color(const float* __restrict__ harm, int n,
                                         int i, float px, float py, float pz,
                                         float cx, float cy, float cz,
                                         int srgb, float color[3]) {
  constexpr int nc = (SH + 1) * (SH + 1);
  if constexpr (SH == 0) {
    for (int ch = 0; ch < 3; ++ch)
      color[ch] = harm[(ch * nc) * n + i] * 0.28209479177387814f;
  } else {
    const float dx = cx - px;
    const float dy = cy - py;
    const float dz = cz - pz;
    const float inv = 1.0f / sqrtf(jmax(dx * dx + dy * dy + dz * dz, 1e-24f));
    const float bx = dx * inv, by = dy * inv, bz = dz * inv;
    float basis[16];
    basis[0] = 0.28209479177387814f;
    basis[1] = -0.4886025119029199f * by;
    basis[2] = 0.4886025119029199f * bz;
    basis[3] = -0.4886025119029199f * bx;
    if constexpr (SH >= 2) {
      const float bxx = bx * bx, byy = by * by, bzz = bz * bz;
      const float bxy = bx * by, byz = by * bz, bxz = bx * bz;
      basis[4] = 1.0925484305920792f * bxy;
      basis[5] = -1.0925484305920792f * byz;
      basis[6] = 0.31539156525252005f * (2.0f * bzz - bxx - byy);
      basis[7] = -1.0925484305920792f * bxz;
      basis[8] = 0.5462742152960396f * (bxx - byy);
    }
    if constexpr (SH >= 3) {
      const float bxx = bx * bx, byy = by * by, bzz = bz * bz;
      const float bxy = bx * by;
      basis[9] = -0.5900435899266435f * by * (3.0f * bxx - byy);
      basis[10] = 2.890611442640554f * bxy * bz;
      basis[11] = -0.4570457994644658f * by * (4.0f * bzz - bxx - byy);
      basis[12] = 0.3731763325901154f * bz * (2.0f * bzz - 3.0f * bxx - 3.0f * byy);
      basis[13] = -0.4570457994644658f * bx * (4.0f * bzz - bxx - byy);
      basis[14] = 1.445305721320277f * bz * (bxx - byy);
      basis[15] = -0.5900435899266435f * bx * (bxx - 3.0f * byy);
    }
    for (int ch = 0; ch < 3; ++ch) {
      const float* h = harm + static_cast<size_t>(ch * nc) * n + i;
      float acc = h[0] * basis[0];
#pragma unroll
      for (int c = 1; c < nc; ++c) acc = acc + h[static_cast<size_t>(c) * n] * basis[c];
      color[ch] = acc;
    }
  }
  for (int ch = 0; ch < 3; ++ch) {
    float c = jmax(color[ch] + 0.5f, 0.0f);
    if (srgb) {
      c = jclip(c, 0.0f, 1.0f);
      c = c <= 0.04045f ? c / 12.92f
                        : powf((jclip(c, 0.0f, 1.0f) + 0.055f) / 1.055f, 2.4f);
    }
    color[ch] = c;
  }
}

// theta of the eigenvector packed to u16 (the JAX epilogue: atan2, mod pi,
// where(vis, theta, 0), mod pi, * 65535 / pi + 0.5).
__device__ __forceinline__ uint32_t theta_u16(float evx, float evy, bool vis,
                                              const ProjParams& P) {
  float theta = atan2f(evy, evx);
  theta = jmod(theta, P.pi);
  theta = theta >= P.pi ? theta - P.pi : theta;
  theta = vis ? theta : 0.0f;
  float tq = jmod(theta, P.pi);
  tq = tq < 0.0f ? tq + P.pi : tq;
  return static_cast<uint32_t>(
      static_cast<int>(jclip(tq * P.theta_scale + 0.5f, 0.0f, 65535.0f)));
}

// compute_tile_bounds_c: clamped inclusive tile rect (tile_w x tile_h
// tiles).  The JAX reference divides by the side under jit, where XLA
// folds the division by a constant into a multiply by its float32
// reciprocal; so does this: floor(xmin * (1 / tile_w)), with the
// reciprocal rounded once (an IEEE division, equal to the host's float32
// 1 / tile_w at every side up to 4096).  At a side that is not a power of
// two it can split a bound within an ulp of a tile edge differently from
// an exact division; at a power of two the two agree bit for bit.
__device__ __forceinline__ void tile_bounds(float sx, float sy, float ex,
                                            float ey, const ProjParams& P,
                                            int tiles_x, int tiles_y,
                                            int tile_w, int tile_h,
                                            int* min_tx,
                                            int* max_tx, int* min_ty,
                                            int* max_ty) {
  const float xmin = jclip(sx - ex, 0.0f, P.wm1);
  const float xmax = jclip(sx + ex, 0.0f, P.wm1);
  const float ymin = jclip(sy - ey, 0.0f, P.hm1);
  const float ymax = jclip(sy + ey, 0.0f, P.hm1);
  const float rw = 1.0f / static_cast<float>(tile_w);
  *min_tx = max(static_cast<int>(floorf(xmin * rw)), 0);
  *max_tx = min(static_cast<int>(ceilf(xmax * rw)) - 1, tiles_x - 1);
  const float rh = 1.0f / static_cast<float>(tile_h);
  *min_ty = max(static_cast<int>(floorf(ymin * rh)), 0);
  *max_ty = min(static_cast<int>(ceilf(ymax * rh)) - 1, tiles_y - 1);
}

__device__ __forceinline__ bool off_screen(float sx, float sy, float ex,
                                           float ey, const ProjParams& P) {
  return (sx + ex < 0.0f) || (sx - ex > P.width) || (sy + ey < 0.0f) ||
         (sy - ey > P.height);
}

// Sortable depth word, KeyPlan-normalized (culled gaussians at the span).
__device__ __forceinline__ uint32_t depth_word(float depth, bool alive,
                                               const ProjInts& Q) {
  const uint32_t dbits = __float_as_uint(depth);
  const uint32_t dkey =
      alive ? dbits ^ ((dbits & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u)
            : 0xFFFFFFFFu;
  uint32_t dsw = dkey;
  if (Q.has_plan) {
    const uint32_t dd = (dkey > Q.near_key ? dkey : Q.near_key) - Q.near_key;
    dsw = dd < Q.span ? dd : Q.span;
    dsw = alive ? dsw : Q.span;
  }
  return dsw;
}

// The 16-bit half-depth key (mathlib.half_depth_key16) of the record's
// quantized f16 depth bits d16; 0xFFFFFFFF where culled.
__device__ __forceinline__ uint32_t depth_key16(uint32_t d16, bool alive) {
  const uint32_t dk16 = (d16 & 0x8000u) ? (~d16 & 0xFFFFu) : (d16 ^ 0x8000u);
  return alive ? dk16 : 0xFFFFFFFFu;
}

__device__ __forceinline__ uint32_t rect_word_of(int min_tx, int min_ty,
                                                 int rect_w, bool alive) {
  uint32_t rw = static_cast<uint32_t>(min_tx) |
                (static_cast<uint32_t>(min_ty) << 10) |
                (static_cast<uint32_t>(rect_w) << 20);
  return alive ? rw : (rw | GSM_CULLED_BIT);
}

template <int SH>
__global__ void project_kernel(const float* __restrict__ comp,
                               const float* __restrict__ harm, ProjParams P,
                               ProjInts Q, int32_t* __restrict__ rect_word,
                               int32_t* __restrict__ rect_h_out,
                               int32_t* __restrict__ dsw_out,
                               int32_t* __restrict__ w0_out,
                               int32_t* __restrict__ w1_out,
                               int32_t* __restrict__ w2_out,
                               int32_t* __restrict__ w3_out,
                               uint8_t* __restrict__ visible) {
  const int n = Q.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = comp[0 * n + i], py = comp[1 * n + i], pz = comp[2 * n + i];
  const float sx = comp[3 * n + i], sy = comp[4 * n + i], sz = comp[5 * n + i];
  const float qx = comp[6 * n + i], qy = comp[7 * n + i];
  const float qz = comp[8 * n + i], qw = comp[9 * n + i];
  const float opacity = comp[10 * n + i];
  const float* V = P.view;
  const float* M = P.proj;

  // cull by scale, projection
  bool alive = !(jmax(jmax(sx, sy), sz) < 5e-4f);
  const float vx = V[0] * px + V[1] * py + V[2] * pz + V[3];
  const float vy = V[4] * px + V[5] * py + V[6] * pz + V[7];
  const float vz = V[8] * px + V[9] * py + V[10] * pz + V[11];
  const float cx = M[0] * vx + M[1] * vy + M[2] * vz + M[3];
  const float cy = M[4] * vx + M[5] * vy + M[6] * vz + M[7];
  const float depth = M[12] * vx + M[13] * vy + M[14] * vz + M[15];
  alive = alive && (depth > P.near_plane);
  const float safe_w = fabsf(depth) > 1e-12f ? depth : 1e-12f;
  const float inv_w = 1.0f / safe_w;
  const float nx = cx * inv_w, ny = cy * inv_w;
  alive = alive && !(depth > P.far_plane);
  const float screen_x = (nx + 1.0f) * P.half_w;
  const float screen_y = (ny + 1.0f) * P.half_h;
  alive = alive && (opacity >= P.alpha_threshold);

  float ca, cb, cd;
  covariance_2d(covariance_3d(sx, sy, sz, qx, qy, qz, qw), vx, vy, vz, P, &ca,
                &cb, &cd);
  float evx, evy, sigma1, sigma2;
  alive = alive && theta_sigmas(ca, cb, cd, &evx, &evy, &sigma1, &sigma2);
  const float radius = 3.0f * jmax(sigma1, sigma2);
  alive = alive && !(radius < 0.5f);
  alive = alive && !ink_culled(opacity, ca * cd - cb * cb, depth, P);
  float obb_x, obb_y;
  obb_extents(ca, cb, cd, &obb_x, &obb_y);
  alive = alive && !off_screen(screen_x, screen_y, obb_x, obb_y, P);

  float color[3];
  sh_color<SH>(harm, n, i, px, py, pz, P.center[0], P.center[1], P.center[2],
               Q.srgb, color);

  // quantized record words; theta (atan2 + the u16 packing) folded in
  const uint32_t w0 = f32_to_f16_bits(screen_x) | (f32_to_f16_bits(screen_y) << 16);
  const uint32_t w1 = theta_u16(evx, evy, true, P) | (f32_to_f16_bits(sigma1) << 16);
  const uint32_t w2 = f32_to_f16_bits(sigma2) | (f32_to_f16_bits(depth) << 16);
  const uint32_t op_u8 = quant_u8(opacity);
  const uint32_t w3 = quant_u8(color[0]) | (quant_u8(color[1]) << 8) |
                      (quant_u8(color[2]) << 16) | (op_u8 << 24);

  // clamped tile rect and the d2 cutoff of the quantized opacity
  int min_tx, max_tx, min_ty, max_ty;
  tile_bounds(screen_x, screen_y, obb_x, obb_y, P, Q.tiles_x, Q.tiles_y,
              Q.tile_w, Q.tile_h, &min_tx, &max_tx, &min_ty, &max_ty);
  alive = alive && (min_tx <= max_tx) && (min_ty <= max_ty);
  const float opacity_q = static_cast<float>(static_cast<int>(op_u8)) * P.inv255;
  alive = alive && (d2_cutoff(opacity_q, P.tau) >= 0.0f);

  min_tx = alive ? min_tx : 0;
  min_ty = alive ? min_ty : 0;
  const int rect_w = alive ? max_tx - min_tx + 1 : 1;
  const int rect_h = alive ? max_ty - min_ty + 1 : 1;

  rect_word[i] = static_cast<int32_t>(rect_word_of(min_tx, min_ty, rect_w, alive));
  rect_h_out[i] = rect_h;
  dsw_out[i] = static_cast<int32_t>(Q.key16 ? depth_key16(w2 >> 16, alive)
                                             : depth_word(depth, alive, Q));
  w0_out[i] = static_cast<int32_t>(w0);
  w1_out[i] = static_cast<int32_t>(w1);
  w2_out[i] = static_cast<int32_t>(w2);
  w3_out[i] = static_cast<int32_t>(w3);
  visible[i] = alive ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Kernel 6: the dual-eye (side-by-side stereo) projection.
// ---------------------------------------------------------------------------

struct StereoExtra {
  float st[16];      // scene transform (world -> scene), row-major
  float scene_scale; // |st[:3, 0]|
  float mid[3];      // mid camera centre (SH view direction)
};

// One eye's projection chain (kernels/project.py::_eye_chain).
struct Eye {
  float screen_x, screen_y, depth, evx, evy, sigma1, sigma2, det;
  float px_min, px_max, py_min, py_max;
  int min_tx, max_tx, min_ty, max_ty;
  bool ok;
};

__device__ __forceinline__ Eye eye_chain(float px, float py, float pz,
                                         const Cov3& c3d, const ProjParams& P,
                                         const ProjInts& Q) {
  const float* V = P.view;
  const float* M = P.proj;
  Eye e;
  const float vx = V[0] * px + V[1] * py + V[2] * pz + V[3];
  const float vy = V[4] * px + V[5] * py + V[6] * pz + V[7];
  const float vz = V[8] * px + V[9] * py + V[10] * pz + V[11];
  const float cx = M[0] * vx + M[1] * vy + M[2] * vz + M[3];
  const float cy = M[4] * vx + M[5] * vy + M[6] * vz + M[7];
  e.depth = M[12] * vx + M[13] * vy + M[14] * vz + M[15];
  const float safe_w = fabsf(e.depth) > 1e-12f ? e.depth : 1e-12f;
  const float inv_w = 1.0f / safe_w;
  const float nx = cx * inv_w, ny = cy * inv_w;
  bool ok = (e.depth > P.near_plane) && !(e.depth > P.far_plane);
  e.screen_x = (nx + 1.0f) * P.half_w;
  e.screen_y = (ny + 1.0f) * P.half_h;

  float ca, cb, cd;
  covariance_2d(c3d, vx, vy, vz, P, &ca, &cb, &cd);
  ok = ok && theta_sigmas(ca, cb, cd, &e.evx, &e.evy, &e.sigma1, &e.sigma2);
  e.det = ca * cd - cb * cb;
  ok = ok && !(3.0f * jmax(e.sigma1, e.sigma2) < 0.5f);
  float obb_x, obb_y;
  obb_extents(ca, cb, cd, &obb_x, &obb_y);
  ok = ok && !off_screen(e.screen_x, e.screen_y, obb_x, obb_y, P);
  tile_bounds(e.screen_x, e.screen_y, obb_x, obb_y, P, Q.tiles_x, Q.tiles_y,
              Q.tile_w, Q.tile_h, &e.min_tx, &e.max_tx, &e.min_ty,
              &e.max_ty);
  e.ok = ok && (e.min_tx <= e.max_tx) && (e.min_ty <= e.max_ty);
  e.px_min = jclip(e.screen_x - obb_x, 0.0f, P.width);
  e.px_max = jclip(e.screen_x + obb_x, 0.0f, P.width);
  e.py_min = jclip(e.screen_y - obb_y, 0.0f, P.height);
  e.py_max = jclip(e.screen_y + obb_y, 0.0f, P.height);
  return e;
}

// Record words (w0, w1, w2) of one eye; an eye that does not see the
// gaussian gets mean -6e4 and sigmas 1, so its alpha is exactly 0.
__device__ __forceinline__ void eye_words(const Eye& e, bool vis,
                                          const ProjParams& P, uint32_t* w0,
                                          uint32_t* w1, uint32_t* w2) {
  const uint32_t mx = f32_to_f16_bits(vis ? e.screen_x : -6e4f);
  const uint32_t my = f32_to_f16_bits(vis ? e.screen_y : -6e4f);
  const uint32_t s1 = f32_to_f16_bits(vis ? e.sigma1 : 1.0f);
  const uint32_t s2 = f32_to_f16_bits(vis ? e.sigma2 : 1.0f);
  const uint32_t dp = f32_to_f16_bits(vis ? e.depth : 0.0f);
  *w0 = mx | (my << 16);
  *w1 = theta_u16(e.evx, e.evy, vis, P) | (s1 << 16);
  *w2 = s2 | (dp << 16);
}

// ints: (10, n) = rect_word, rect_h, dsw, w0l, w1l, w2l, w3, w0r, w1r, w2r;
// bounds: (4, n) = px_min, px_max, py_min, py_max of the union.
template <int SH>
__global__ void stereo_project_kernel(const float* __restrict__ comp,
                                      const float* __restrict__ harm,
                                      ProjParams PL, ProjParams PR,
                                      StereoExtra X, ProjInts Q,
                                      int32_t* __restrict__ ints,
                                      float* __restrict__ bounds,
                                      uint8_t* __restrict__ visible) {
  const int n = Q.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px0 = comp[0 * n + i], py0 = comp[1 * n + i], pz0 = comp[2 * n + i];
  const float sx = comp[3 * n + i], sy = comp[4 * n + i], sz = comp[5 * n + i];
  const float opacity = comp[10 * n + i];
  const bool shared_ok =
      !(jmax(jmax(sx, sy), sz) < 5e-4f) && (opacity >= PL.alpha_threshold);

  const float* S = X.st;
  const float px = S[0] * px0 + S[1] * py0 + S[2] * pz0 + S[3];
  const float py = S[4] * px0 + S[5] * py0 + S[6] * pz0 + S[7];
  const float pz = S[8] * px0 + S[9] * py0 + S[10] * pz0 + S[11];
  const Cov3 c3d = covariance_3d(sx * X.scene_scale, sy * X.scene_scale,
                                 sz * X.scene_scale, comp[6 * n + i],
                                 comp[7 * n + i], comp[8 * n + i],
                                 comp[9 * n + i]);
  const Eye L = eye_chain(px, py, pz, c3d, PL, Q);
  const Eye R = eye_chain(px, py, pz, c3d, PR, Q);
  const bool vis_l = L.ok && shared_ok;
  const bool vis_r = R.ok && shared_ok;
  bool any_vis = vis_l || vis_r;
  const bool both = vis_l && vis_r;
  const float check_depth =
      both ? 0.5f * (L.depth + R.depth) : (vis_l ? L.depth : R.depth);
  const float det = both ? jmax(L.det, R.det) : (vis_l ? L.det : R.det);
  any_vis = any_vis && !ink_culled(opacity, det, check_depth, PL);

  float color[3];
  sh_color<SH>(harm, n, i, px, py, pz, X.mid[0], X.mid[1], X.mid[2], Q.srgb,
               color);
  const uint32_t w3 = quant_u8(color[0]) | (quant_u8(color[1]) << 8) |
                      (quant_u8(color[2]) << 16) | (quant_u8(opacity) << 24);

  // union tile and pixel bounds over the eyes that see the gaussian
  constexpr int big = 1 << 20;
  constexpr float bigf = static_cast<float>(1 << 20);
  const int min_tx = min(vis_l ? L.min_tx : big, vis_r ? R.min_tx : big);
  const int max_tx = max(vis_l ? L.max_tx : -big, vis_r ? R.max_tx : -big);
  const int min_ty = min(vis_l ? L.min_ty : big, vis_r ? R.min_ty : big);
  const int max_ty = max(vis_l ? L.max_ty : -big, vis_r ? R.max_ty : -big);
  const float px_min = jmin(vis_l ? L.px_min : bigf, vis_r ? R.px_min : bigf);
  const float px_max = jmax(vis_l ? L.px_max : -bigf, vis_r ? R.px_max : -bigf);
  const float py_min = jmin(vis_l ? L.py_min : bigf, vis_r ? R.py_min : bigf);
  const float py_max = jmax(vis_l ? L.py_max : -bigf, vis_r ? R.py_max : -bigf);
  any_vis = any_vis && (min_tx <= max_tx) && (min_ty <= max_ty);

  uint32_t w0l, w1l, w2l, w0r, w1r, w2r;
  eye_words(L, vis_l, PL, &w0l, &w1l, &w2l);
  eye_words(R, vis_r, PR, &w0r, &w1r, &w2r);

  const int mtx = any_vis ? min_tx : 0;
  const int mty = any_vis ? min_ty : 0;
  const int rect_w = any_vis ? max_tx - mtx + 1 : 1;
  const int rect_h = any_vis ? max_ty - mty + 1 : 1;
  const size_t N = static_cast<size_t>(n);
  ints[0 * N + i] = static_cast<int32_t>(rect_word_of(mtx, mty, rect_w, any_vis));
  ints[1 * N + i] = rect_h;
  ints[2 * N + i] = static_cast<int32_t>(depth_word(check_depth, any_vis, Q));
  ints[3 * N + i] = static_cast<int32_t>(w0l);
  ints[4 * N + i] = static_cast<int32_t>(w1l);
  ints[5 * N + i] = static_cast<int32_t>(w2l);
  ints[6 * N + i] = static_cast<int32_t>(w3);
  ints[7 * N + i] = static_cast<int32_t>(w0r);
  ints[8 * N + i] = static_cast<int32_t>(w1r);
  ints[9 * N + i] = static_cast<int32_t>(w2r);
  bounds[0 * N + i] = any_vis ? px_min : 0.0f;
  bounds[1 * N + i] = any_vis ? px_max : 0.0f;
  bounds[2 * N + i] = any_vis ? py_min : 0.0f;
  bounds[3 * N + i] = any_vis ? py_max : 0.0f;
  visible[i] = any_vis ? 1 : 0;
}

ProjInts load_ints(const int* ints, const uint32_t* plan) {
  ProjInts Q;
  Q.n = ints[0];
  Q.tiles_x = ints[1];
  Q.tiles_y = ints[2];
  Q.sh_degree = ints[3];
  Q.srgb = ints[4];
  Q.has_plan = ints[5];
  Q.tile_w = ints[6];
  Q.key16 = ints[7];
  Q.tile_h = ints[8];
  Q.near_key = plan[0];
  Q.span = plan[1];
  return Q;
}

// ints: n, tiles_x, tiles_y, sh_degree, srgb, has_plan, tile_w, key16,
// tile_h (tile sides 1 to 4096); plan: the KeyPlan's near_key and span.
extern "C" int gsm_project(const float* comp, const float* harm,
                           const float* params, const int* ints,
                           const uint32_t* plan, void* rect_word, void* rect_h,
                           void* dsw, void* w0, void* w1, void* w2, void* w3,
                           void* visible, cudaStream_t stream) {
  ProjParams P;
  memcpy(&P, params, sizeof(ProjParams));
  const ProjInts Q = load_ints(ints, plan);
  if (!tile_side_ok(Q.tile_w) || !tile_side_ok(Q.tile_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q.n > 0) {
    const int threads = 256;
    const int blocks = (Q.n + threads - 1) / threads;
    auto kernel = Q.sh_degree == 0   ? project_kernel<0>
                  : Q.sh_degree == 1 ? project_kernel<1>
                  : Q.sh_degree == 2 ? project_kernel<2>
                                     : project_kernel<3>;
    kernel<<<blocks, threads, 0, stream>>>(
        comp, harm, P, Q, static_cast<int32_t*>(rect_word),
        static_cast<int32_t*>(rect_h), static_cast<int32_t*>(dsw),
        static_cast<int32_t*>(w0), static_cast<int32_t*>(w1),
        static_cast<int32_t*>(w2), static_cast<int32_t*>(w3),
        static_cast<uint8_t*>(visible));
  }
  return static_cast<int>(cudaGetLastError());
}

// params: the left eye's ProjParams, the right eye's, then StereoExtra.
// ints as for gsm_project: n, tiles_x, tiles_y, sh_degree, srgb, has_plan,
// tile_w, key16 (0 here), tile_h.
extern "C" int gsm_stereo_project(const float* comp, const float* harm,
                                  const float* params, const int* ints,
                                  const uint32_t* plan, int32_t* out_ints,
                                  float* out_bounds, uint8_t* visible,
                                  cudaStream_t stream) {
  ProjParams PL, PR;
  StereoExtra X;
  memcpy(&PL, params, sizeof(ProjParams));
  memcpy(&PR, params + sizeof(ProjParams) / sizeof(float), sizeof(ProjParams));
  memcpy(&X, params + 2 * (sizeof(ProjParams) / sizeof(float)),
         sizeof(StereoExtra));
  const ProjInts Q = load_ints(ints, plan);
  if (!tile_side_ok(Q.tile_w) || !tile_side_ok(Q.tile_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q.n > 0) {
    const int threads = 256;
    const int blocks = (Q.n + threads - 1) / threads;
    auto kernel = Q.sh_degree == 0   ? stereo_project_kernel<0>
                  : Q.sh_degree == 1 ? stereo_project_kernel<1>
                  : Q.sh_degree == 2 ? stereo_project_kernel<2>
                                     : stereo_project_kernel<3>;
    kernel<<<blocks, threads, 0, stream>>>(comp, harm, PL, PR, X, Q, out_ints,
                                           out_bounds, visible);
  }
  return static_cast<int>(cudaGetLastError());
}
