// Kernel 5: front-to-back tile blend, one CTA per 16x16 tile, one thread
// per pixel, writing the color and depth images directly (assemble fused,
// ragged edge masked).  kEyes = 2 is the single-pass dual-eye stereo blend:
// the sorted table carries both eyes' records (8 words: left w0..w3, right
// w0..w3), each pixel keeps one accumulator and transmittance per eye, and
// eye e writes columns [e * width, (e + 1) * width) of an (H, 2W) image.
//
// Replaces the Pallas kernel gsm_renderer_tpu/kernels/blend.py::
// _row_blend_kernel (blend_tiles_pallas, exponent_mode "vpu", depth modes
// "weighted" and "none", n_eyes 1 and 2, r2_cutoff, pixel_coords) and the
// XLA assemble_image after it.
//
// Pixel coordinates: pixel p = ly * 16 + lx of tile (tx, ty) sits at (tx *
// 16 + lx, ty * 16 + ly), or, with the foveated coordinate tables coord_x
// (tiles_x, 256) and coord_y (tiles_y, 256), at the display-space point
// (coord_x[tx][p], coord_y[ty][p]) it samples (256 consecutive floats per
// tile: coalesced).  Writes stay clipped to width x height either way.
//
// Per record: centred linear forms u = a1 dx + b1 dy, v = a2 dx + b2 dy with
// dx = px - mx at integer pixel corners (no +0.5), alpha = min(exp(-q/2 +
// log op), 0.99), then alpha = 0 where q > r2_cutoff (when r2_cutoff > 0:
// the stereo blend's r^2 <= 9 cutoff); f16 fields decode with subnormals
// flushed to zero.
//
// Batches and early exit: the tile's span [start, start + count) is walked
// in batches of 256 records aligned to 128-record blocks -- batch 0 ends at
// (start / 128 + 2) * 128, later batches are 256 long -- which are exactly
// the Pallas kernel's 2 x 128-slot chunks.  Each thread decodes one record
// of the batch (per eye) into shared memory, then every thread composites
// the batch's records in order.  After each batch the tile stops once every
// pixel's transmittance is below 1/255 in every eye (__syncthreads_or over
// the larger of the eyes' transmittances): the Pallas kernel's tile-level
// exit, which for two eyes waits until both saturate.  The plain version
// (kernels/blend.py) applies the same rule; the XLA reference blend never
// exits.
//
// Bound on the H100: float operations (~25 per pixel, record and eye
// processed) and the SFU's exp; the records (16 B per eye) are read once per
// tile.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kBatch = 256;

struct Batch {
  float mx[kBatch], my[kBatch], a1[kBatch], b1[kBatch], a2[kBatch],
      b2[kBatch], lop[kBatch], r[kBatch], g[kBatch], b[kBatch], d[kBatch];
};

template <int kEyes>
__global__ void __launch_bounds__(kPix)
blend_kernel(const int32_t* __restrict__ table, int capacity,
             const int32_t* __restrict__ starts,
             const int32_t* __restrict__ counts, int tiles_x, int width,
             int height, int with_depth, float theta_unit, float inv255,
             float min_transmittance, float r2_cutoff,
             const float* __restrict__ coord_x,
             const float* __restrict__ coord_y,
             float* __restrict__ color, float* __restrict__ depth) {
  __shared__ Batch sb[kEyes];

  const int tile = blockIdx.x;
  const int tx = tile % tiles_x, ty = tile / tiles_x;
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  float pxf, pyf;
  if (coord_x != nullptr) {
    pxf = coord_x[static_cast<size_t>(tx) * kPix + threadIdx.x];
    pyf = coord_y[static_cast<size_t>(ty) * kPix + threadIdx.x];
  } else {
    pxf = static_cast<float>(lx) + static_cast<float>(tx * kTile);
    pyf = static_cast<float>(ly) + static_cast<float>(ty * kTile);
  }
  const size_t C = static_cast<size_t>(capacity);

  const int start = starts[tile];
  const int end = start + counts[tile];
  float trans[kEyes], acc_r[kEyes], acc_g[kEyes], acc_b[kEyes], acc_d[kEyes];
#pragma unroll
  for (int e = 0; e < kEyes; ++e) {
    trans[e] = 1.0f;
    acc_r[e] = acc_g[e] = acc_b[e] = acc_d[e] = 0.0f;
  }

  for (int b0 = (start / 128) * 128; b0 < end; b0 += kBatch) {
    const int lo = max(b0, start) - b0, hi = min(b0 + kBatch, end) - b0;
    const int j = threadIdx.x;
    if (j >= lo && j < hi) {
      const size_t idx = static_cast<size_t>(b0 + j);
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        const uint32_t a0 = static_cast<uint32_t>(table[(4 * e + 0) * C + idx]);
        const uint32_t a1 = static_cast<uint32_t>(table[(4 * e + 1) * C + idx]);
        const uint32_t a2 = static_cast<uint32_t>(table[(4 * e + 2) * C + idx]);
        const uint32_t a3 = static_cast<uint32_t>(table[(4 * e + 3) * C + idx]);
        const float theta =
            static_cast<float>(static_cast<int>(a1 & 0xFFFFu)) * theta_unit;
        const float s1 = jmax(f16_bits_to_f32(a1 >> 16), 1e-4f);
        const float s2 = jmax(f16_bits_to_f32(a2), 1e-4f);
        const float cth = cosf(theta), sth = sinf(theta);
        const float i1 = 1.0f / s1, i2 = 1.0f / s2;
        Batch& B = sb[e];
        B.mx[j] = f16_bits_to_f32(a0);
        B.my[j] = f16_bits_to_f32(a0 >> 16);
        B.d[j] = f16_bits_to_f32(a2 >> 16);
        B.r[j] = u8f(a3, 0, inv255);
        B.g[j] = u8f(a3, 8, inv255);
        B.b[j] = u8f(a3, 16, inv255);
        B.lop[j] = logf(u8f(a3, 24, inv255));
        B.a1[j] = cth * i1;
        B.b1[j] = sth * i1;
        B.a2[j] = -sth * i2;
        B.b2[j] = cth * i2;
      }
    }
    __syncthreads();
    for (int k = lo; k < hi; ++k) {
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        const Batch& B = sb[e];
        const float dx = pxf - B.mx[k];
        const float dy = pyf - B.my[k];
        const float u = B.a1[k] * dx + B.b1[k] * dy;
        const float v = B.a2[k] * dx + B.b2[k] * dy;
        const float q = u * u + v * v;
        float alpha = jmin(expf(q * -0.5f + B.lop[k]), 0.99f);
        if (r2_cutoff > 0.0f && q > r2_cutoff) alpha = 0.0f;
        const float w = alpha * trans[e];
        acc_r[e] = acc_r[e] + w * B.r[k];
        acc_g[e] = acc_g[e] + w * B.g[k];
        acc_b[e] = acc_b[e] + w * B.b[k];
        acc_d[e] = acc_d[e] + w * B.d[k];
        trans[e] = trans[e] * (1.0f - alpha);
      }
    }
    // barrier (also protects the shared batch) + tile-level early exit
    float tmax = trans[0];
#pragma unroll
    for (int e = 1; e < kEyes; ++e) tmax = jmax(tmax, trans[e]);
    if (!__syncthreads_or(tmax >= min_transmittance)) break;
  }

  if (x < width && y < height) {
#pragma unroll
    for (int e = 0; e < kEyes; ++e) {
      const size_t p = static_cast<size_t>(y) * (kEyes * width) + e * width + x;
      float4 c;
      c.x = acc_r[e];
      c.y = acc_g[e];
      c.z = acc_b[e];
      c.w = 1.0f - trans[e];
      reinterpret_cast<float4*>(color)[p] = c;
      if (with_depth) depth[p] = acc_d[e];
    }
  }
}

}  // namespace

// table: (4 * n_eyes, capacity) record words; coord_x (tiles_x, 256) and
// coord_y (tiles_y, 256) the foveated pixel coordinates, or both null;
// color (H, n_eyes * W, 4), depth (H, n_eyes * W) when with_depth.
extern "C" int gsm_blend(const int32_t* table, int capacity, int n_eyes,
                         const int32_t* starts, const int32_t* counts,
                         int tiles_x, int tiles_y, int width, int height,
                         int with_depth, float theta_unit, float inv255,
                         float min_transmittance, float r2_cutoff,
                         const float* coord_x, const float* coord_y,
                         float* color, float* depth, cudaStream_t stream) {
  if (n_eyes != 1 && n_eyes != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles > 0) {
    auto kernel = n_eyes == 2 ? blend_kernel<2> : blend_kernel<1>;
    kernel<<<n_tiles, kPix, 0, stream>>>(
        table, capacity, starts, counts, tiles_x, width, height, with_depth,
        theta_unit, inv255, min_transmittance, r2_cutoff, coord_x, coord_y,
        color, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
