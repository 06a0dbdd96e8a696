// Kernel 4: front-to-back tile blend, one CTA per 16x16 tile, one thread
// per pixel, writing the (H, W, 4) color and (H, W) depth images directly
// (assemble fused, ragged edge masked).
//
// Replaces the Pallas kernel gsm_renderer_tpu/kernels/blend.py::
// _row_blend_kernel (blend_tiles_pallas, exponent_mode "vpu", depth modes
// "weighted" and "none") and the XLA assemble_image after it.
//
// Per record: centred linear forms u = a1 dx + b1 dy, v = a2 dx + b2 dy with
// dx = px - mx at integer pixel corners (no +0.5), alpha = min(exp(-q/2 +
// log op), 0.99); f16 fields decode with subnormals flushed to zero.
//
// Batches and early exit: the tile's span [start, start + count) is walked
// in batches of 256 records aligned to 128-record blocks -- batch 0 ends at
// (start / 128 + 2) * 128, later batches are 256 long -- which are exactly
// the Pallas kernel's 2 x 128-slot chunks.  Each thread decodes one record
// of the batch into shared memory, then every thread composites the batch's
// records in order.  After each batch the tile stops once every pixel's
// transmittance is below 1/255 (__syncthreads_or), the Pallas kernel's
// tile-level exit.  The plain version (kernels/blend.py) applies the same
// rule; the XLA reference blend never exits.
//
// Bound on the H100: float operations (~25 per pixel and record processed)
// and the SFU's exp; the records (16 B each) are read once per tile.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kBatch = 256;

__global__ void __launch_bounds__(kPix)
blend_kernel(const int32_t* __restrict__ w0, const int32_t* __restrict__ w1,
             const int32_t* __restrict__ w2, const int32_t* __restrict__ w3,
             const int32_t* __restrict__ starts,
             const int32_t* __restrict__ counts, int tiles_x, int width,
             int height, int with_depth, float theta_unit, float inv255,
             float min_transmittance, float* __restrict__ color,
             float* __restrict__ depth) {
  __shared__ float s_mx[kBatch], s_my[kBatch], s_a1[kBatch], s_b1[kBatch];
  __shared__ float s_a2[kBatch], s_b2[kBatch], s_lop[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_b[kBatch], s_d[kBatch];

  const int tile = blockIdx.x;
  const int tx = tile % tiles_x, ty = tile / tiles_x;
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  const float pxf = static_cast<float>(lx) + static_cast<float>(tx * kTile);
  const float pyf = static_cast<float>(ly) + static_cast<float>(ty * kTile);

  const int start = starts[tile];
  const int end = start + counts[tile];
  float trans = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  for (int b0 = (start / 128) * 128; b0 < end; b0 += kBatch) {
    const int lo = max(b0, start) - b0, hi = min(b0 + kBatch, end) - b0;
    const int j = threadIdx.x;
    if (j >= lo && j < hi) {
      const int idx = b0 + j;
      const uint32_t a0 = static_cast<uint32_t>(w0[idx]);
      const uint32_t a1 = static_cast<uint32_t>(w1[idx]);
      const uint32_t a2 = static_cast<uint32_t>(w2[idx]);
      const uint32_t a3 = static_cast<uint32_t>(w3[idx]);
      const float theta =
          static_cast<float>(static_cast<int>(a1 & 0xFFFFu)) * theta_unit;
      const float s1 = jmax(f16_bits_to_f32(a1 >> 16), 1e-4f);
      const float s2 = jmax(f16_bits_to_f32(a2), 1e-4f);
      const float cth = cosf(theta), sth = sinf(theta);
      const float i1 = 1.0f / s1, i2 = 1.0f / s2;
      s_mx[j] = f16_bits_to_f32(a0);
      s_my[j] = f16_bits_to_f32(a0 >> 16);
      s_d[j] = f16_bits_to_f32(a2 >> 16);
      s_r[j] = u8f(a3, 0, inv255);
      s_g[j] = u8f(a3, 8, inv255);
      s_b[j] = u8f(a3, 16, inv255);
      s_lop[j] = logf(u8f(a3, 24, inv255));
      s_a1[j] = cth * i1;
      s_b1[j] = sth * i1;
      s_a2[j] = -sth * i2;
      s_b2[j] = cth * i2;
    }
    __syncthreads();
    for (int k = lo; k < hi; ++k) {
      const float dx = pxf - s_mx[k];
      const float dy = pyf - s_my[k];
      const float u = s_a1[k] * dx + s_b1[k] * dy;
      const float v = s_a2[k] * dx + s_b2[k] * dy;
      const float q = u * u + v * v;
      const float alpha = jmin(expf(q * -0.5f + s_lop[k]), 0.99f);
      const float w = alpha * trans;
      acc_r = acc_r + w * s_r[k];
      acc_g = acc_g + w * s_g[k];
      acc_b = acc_b + w * s_b[k];
      acc_d = acc_d + w * s_d[k];
      trans = trans * (1.0f - alpha);
    }
    // barrier (also protects the shared batch) + tile-level early exit
    if (!__syncthreads_or(trans >= min_transmittance)) break;
  }

  if (x < width && y < height) {
    const size_t p = static_cast<size_t>(y) * width + x;
    float4 c;
    c.x = acc_r;
    c.y = acc_g;
    c.z = acc_b;
    c.w = 1.0f - trans;
    reinterpret_cast<float4*>(color)[p] = c;
    if (with_depth) depth[p] = acc_d;
  }
}

}  // namespace

extern "C" int gsm_blend(const int32_t* w0, const int32_t* w1,
                         const int32_t* w2, const int32_t* w3,
                         const int32_t* starts, const int32_t* counts,
                         int tiles_x, int tiles_y, int width, int height,
                         int with_depth, float theta_unit, float inv255,
                         float min_transmittance, float* color, float* depth,
                         cudaStream_t stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles > 0) {
    blend_kernel<<<n_tiles, kPix, 0, stream>>>(
        w0, w1, w2, w3, starts, counts, tiles_x, width, height, with_depth,
        theta_unit, inv255, min_transmittance, color, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
