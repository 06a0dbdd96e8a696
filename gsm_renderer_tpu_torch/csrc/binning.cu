// Binning kernels: prep (kernel 2), row expansion (kernel 3), slot
// expansion (kernel 4) and the foveated bounds gather (kernel 7), for the
// mono (4 record words), stereo and warped (8 words: the left record, then
// the right; w3 shared) tables with KeyPlan keys.
//
// Prep replaces the Pallas kernel gsm_renderer_tpu/kernels/expand.py::
// _prep_kernel (binning_prep_pallas, modes "mono", "stereo" and "warped",
// options count_rows and lod_min): per gaussian, the exact 8x4 tile mask
// (up to 32 minQuadRect tests: <= the alpha d2 cutoff in mono, either eye
// <= 9 in stereo and warped; warped tests the display-space rect of each
// physical tile and, with lod_min > 0, applies the periphery LOD drop), its
// popcount, the MASKED / CULLED bits and the count -- instances, or virtual
// tile rows under count_rows (every gaussian owns >= 1); then the global
// exclusive scan of the counts.  The Pallas kernel carries the scan across
// its sequential grid in SMEM; blocks here run in no order, so the scan is
// three passes written by hand: a block scan (warp shuffles) that also
// stores each block's sum, one block that scans the block sums and writes
// offsets[n] (the total), and an add-back of the block offsets.
//
// Row expansion replaces _row_expand_kernel (row_expand_pallas): one thread
// per virtual row r < R.  An upper-bound binary search over the prep
// offsets (strictly increasing: every gaussian owns >= 1 row) finds the
// gaussian g and its tile row jj = r - offsets[g]; an oversized rect's row
// is narrowed to the closed-form column span of the ellipse (row_span, the
// formulas of _row_tile_span), and the per-row instance counts go through
// the same three-pass scan, so the output is again a complete table of R
// entries plus offsets[R].  Rows at or past the row total carry zero planes
// and count 0.
//
// Slot expansion replaces _expand_kernel (expand_slots_pallas with a
// prebuilt table and a KeyPlan).  Slot s belongs to the entry g (a gaussian,
// or a row of a row table) with offsets[g] <= s < offsets[g + 1].  Offsets
// rise strictly over live entries; a row table's dead tail repeats the
// total, and since slot < total no live slot lands on a dead row.  The tile
// is the j-th set bit of the mask (MASKED entries) or the row-major walk of
// the rect plus the exact test (mono alpha cutoff, stereo either eye q <= 9,
// warped the same on the tile's display-space rect; under the warp MASKED
// entries are re-tested, as the Pallas kernel does, so that a mask made
// elsewhere, a widened one included, puts no failing tile in the blend).
// Keys: key1 = [tile | depth_hi], key2 = [depth_lo | entry index]; dead
// slots (slot >= total, culled entry, failed test) get the sentinel in both
// keys.  The keys are the whole output: the blend reads an entry's record
// words through the index in key2, so no word is carried per slot.  Slots
// at or beyond the capacity are not written (the grid covers the capacity);
// the caller derives overflow = total > capacity.
//
// The expand is a load-balanced search.  CTA b owns the 1024 slots [1024 b,
// 1024 (b + 1)), four per thread, strided so that writes coalesce.  One
// k-ary search over the offsets in device memory (three rounds of one load
// a thread for a million entries) finds the entry g0 of its first slot; the
// CTA stages the offsets, rect, mask and depth word of entries g0 ..
// g0 + 1024 in shared memory (16 KB; they cover every slot of the CTA), and
// each slot finds its entry with a 10-step binary search there.  Record
// words are read from device memory (L1 serves neighbours) only where the
// exact test reads them.
//
// Bounds gather replaces _bgather_kernel (warped_bounds_gather_pallas): one
// thread per gaussian reads the 9 x and 5 y display coordinates of the
// physical tile boundaries min_t + d of its window, bounds[axis][min(min_t +
// d, 127)], from the (2, 128) float table staged in shared memory (1 KB),
// and writes 14 planes.  The gather is the device function window_bounds,
// which the warped prep calls itself (the JAX production path fuses it the
// same way), so the standalone kernel runs only for callers that want the
// planes.
//
// The warped modes read the bounds table from shared memory: every thread
// of the block stages part of it and passes one barrier before any thread
// leaves.
//
// Bounds on the H100.  Prep: float operations (32 tests of ~65 flops for a
// gaussian whose rect fills the window, twice in stereo and warped) against
// 36-52 B of traffic per gaussian.  Bounds gather: device memory (8 B
// read, 56 B written per gaussian).  Row expansion: device memory (~40 B
// read and 32 B written per row, ~100 flops for the span).  Prep, row
// expansion and the bounds gather are one thread per element, coalesced.
// Expand: device memory, 8 B written per slot (the two keys) and 16 B read
// per entry (offset, rect, mask, depth word) plus the words of the tested
// entries; the per-slot search that bound the first port (~21 dependent
// loads in device memory a slot) is one k-ary search a CTA.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kPrepThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kExpandThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kExpandSlots = kExpandThreads * kSlotsPerThread;
constexpr float kStereoR2Cutoff = 9.0f;
constexpr int kBoundsLanes = 128;

// Binning modes: the record words they carry and the test they apply.
enum Mode { kMono = 0, kStereo = 1, kWarped = 2 };

template <int kMode>
__host__ __device__ constexpr int words_of() { return kMode == kMono ? 4 : 8; }

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Block-wide exclusive scan of one int per thread; returns the exclusive
// prefix and stores the block total in *total.
template <int kThreads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kThreads / 32 ? warp_sums[lane] : 0;
    const int si = warp_inclusive_scan(s);
    if (lane < kThreads / 32) warp_sums[lane] = si;
  }
  __syncthreads();
  const int base = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return base + inc - v;
}

// Index lo in [0, n) with offsets[lo] <= s < offsets[lo + 1], for
// offsets[0] <= s < offsets[n] and non-decreasing offsets.
__device__ __forceinline__ int upper_bound_entry(const int32_t* offsets, int n,
                                                 int s) {
  int lo = 0, hi = n;  // offsets[lo] <= s < offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= s) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ uint32_t word(const WordPtrs& W, int k, int i) {
  return static_cast<uint32_t>(W.w[k][i]);
}

// Copy the (2, 128) bounds table into shared memory; every thread of the
// block calls it, and it ends in a barrier.
__device__ __forceinline__ void stage_bounds(const float* __restrict__ bounds,
                                             float* sb) {
  for (int k = threadIdx.x; k < 2 * kBoundsLanes; k += blockDim.x) {
    sb[k] = bounds[k];
  }
  __syncthreads();
}

// Entry t of one axis row of the bounds table, the index clamped to the row.
__device__ __forceinline__ float bound_at(const float* row, int t) {
  return row[min(max(t, 0), kBoundsLanes - 1)];
}

// Kernel 7's gather: the display coordinates of the physical tile
// boundaries min_tx + 0..8 and min_ty + 0..4 of a gaussian's 8x4 window.
__device__ __forceinline__ void window_bounds(const float* sb, int min_tx,
                                              int min_ty,
                                              float fx[GSM_MASK_W + 1],
                                              float fy[GSM_MASK_H + 1]) {
#pragma unroll
  for (int d = 0; d <= GSM_MASK_W; ++d) fx[d] = bound_at(sb, min_tx + d);
#pragma unroll
  for (int d = 0; d <= GSM_MASK_H; ++d) {
    fy[d] = bound_at(sb + kBoundsLanes, min_ty + d);
  }
}

// out: (GSM_MASK_W + 1 + GSM_MASK_H + 1, n) = fx planes, then fy planes.
__global__ void bounds_gather_kernel(const float* __restrict__ bounds,
                                     const int32_t* __restrict__ min_tx,
                                     const int32_t* __restrict__ min_ty, int n,
                                     float* __restrict__ out) {
  __shared__ float sb[2 * kBoundsLanes];
  stage_bounds(bounds, sb);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float fx[GSM_MASK_W + 1], fy[GSM_MASK_H + 1];
  window_bounds(sb, min_tx[i], min_ty[i], fx, fy);
  const size_t N = static_cast<size_t>(n);
#pragma unroll
  for (int d = 0; d <= GSM_MASK_W; ++d) out[d * N + i] = fx[d];
#pragma unroll
  for (int d = 0; d <= GSM_MASK_H; ++d) out[(GSM_MASK_W + 1 + d) * N + i] = fy[d];
}

// Warped 8x4 window mask: position (dx, dy) tests both eyes' records
// against the display-space rect [fx[dx], fx[dx + 1]] x [fy[dy], fy[dy + 1]]
// (q <= 9), and with lod_min > 0 drops it where op * max_eye(s1 * s2) * ar
// < lod_min * (1 - min(ar, 1)), ar = (16 / rect width) * (16 / rect height)
// (expand.py::stereo_warped_tile_masks).
__device__ __forceinline__ uint32_t warped_window_mask(
    const WordPtrs& W, int i, int min_tx, int min_ty, int rect_w, int rh,
    const float* sb, float lod_min, float theta_unit, float inv255) {
  const uint32_t l1 = word(W, 1, i), l2 = word(W, 2, i);
  const uint32_t r1 = word(W, 5, i), r2 = word(W, 6, i);
  const Conic kl = decode_conic(word(W, 0, i), l1, l2, theta_unit);
  const Conic kr = decode_conic(word(W, 4, i), r1, r2, theta_unit);
  float fx[GSM_MASK_W + 1], fy[GSM_MASK_H + 1];
  window_bounds(sb, min_tx, min_ty, fx, fy);
  float ink = 0.0f;
  if (lod_min > 0.0f) {
    const float s1l = jmax(f16_bits_to_f32(l1 >> 16), 1e-4f);
    const float s2l = jmax(f16_bits_to_f32(l2), 1e-4f);
    const float s1r = jmax(f16_bits_to_f32(r1 >> 16), 1e-4f);
    const float s2r = jmax(f16_bits_to_f32(r2), 1e-4f);
    ink = u8f(word(W, 3, i), 24, inv255) * jmax(s1l * s2l, s1r * s2r);
  }
  uint32_t mask = 0;
#pragma unroll
  for (int dy = 0; dy < GSM_MASK_H; ++dy) {
    if (dy >= rh) break;
    const float y0 = fy[dy], y1 = fy[dy + 1];
#pragma unroll
    for (int dx = 0; dx < GSM_MASK_W; ++dx) {
      if (dx >= rect_w) break;
      const float x0 = fx[dx], x1 = fx[dx + 1];
      const float d2 =
          jmin(d2min_rect(kl, x0 - kl.mx, x1 - kl.mx, y0 - kl.my, y1 - kl.my),
               d2min_rect(kr, x0 - kr.mx, x1 - kr.mx, y0 - kr.my, y1 - kr.my));
      bool pass = d2 <= kStereoR2Cutoff;
      if (lod_min > 0.0f) {
        const float ar = (16.0f / jmax(x1 - x0, 1e-6f)) *
                         (16.0f / jmax(y1 - y0, 1e-6f));
        pass = pass && (ink * ar >= lod_min * (1.0f - jmin(ar, 1.0f)));
      }
      if (pass) mask |= 1u << (dy * GSM_MASK_W + dx);
    }
  }
  return mask;
}

// 8x4 window pass mask at the rect's corner: mono (kWords == 4) tests
// minQuadRect <= the alpha d2 cutoff of the record; stereo (kWords == 8)
// tests min(left, right) <= 9.
template <int kWords>
__device__ __forceinline__ uint32_t window_mask(const WordPtrs& W, int i,
                                                int min_tx, int min_ty,
                                                int rect_w, int rh, float tau,
                                                float theta_unit,
                                                float inv255) {
  const Conic k0 = decode_conic(word(W, 0, i), word(W, 1, i), word(W, 2, i),
                                theta_unit);
  Conic k1 = k0;
  float cutoff;
  if constexpr (kWords == 8) {
    k1 = decode_conic(word(W, 4, i), word(W, 5, i), word(W, 6, i), theta_unit);
    cutoff = kStereoR2Cutoff;
  } else {
    cutoff = d2_cutoff(u8f(word(W, 3, i), 24, inv255), tau);
  }
  const float x0 = static_cast<float>(min_tx) * 16.0f - k0.mx;
  const float y0 = static_cast<float>(min_ty) * 16.0f - k0.my;
  const float x1 = static_cast<float>(min_tx) * 16.0f - k1.mx;
  const float y1 = static_cast<float>(min_ty) * 16.0f - k1.my;
  uint32_t mask = 0;
  for (int dy = 0; dy < GSM_MASK_H && dy < rh; ++dy) {
    const float oy = static_cast<float>(dy * 16);
    for (int dx = 0; dx < GSM_MASK_W && dx < rect_w; ++dx) {
      const float ox = static_cast<float>(dx * 16);
      const float xa = x0 + ox, ya = y0 + oy;
      float d2 = d2min_rect(k0, xa, xa + 16.0f, ya, ya + 16.0f);
      if constexpr (kWords == 8) {
        const float xb = x1 + ox, yb = y1 + oy;
        d2 = jmin(d2, d2min_rect(k1, xb, xb + 16.0f, yb, yb + 16.0f));
      }
      if (d2 <= cutoff) mask |= 1u << (dy * GSM_MASK_W + dx);
    }
  }
  return mask;
}

template <int kMode>
__global__ void prep_kernel(const int32_t* __restrict__ rect_word,
                            const int32_t* __restrict__ rect_h, WordPtrs W,
                            int count_rows, int n, float tau,
                            float theta_unit, float inv255,
                            int32_t* __restrict__ offsets,
                            int32_t* __restrict__ rect_out,
                            int32_t* __restrict__ mask_out,
                            int32_t* __restrict__ block_sums,
                            const float* __restrict__ bounds, float lod_min) {
  __shared__ float sb[kMode == kWarped ? 2 * kBoundsLanes : 1];
  if constexpr (kMode == kWarped) stage_bounds(bounds, sb);
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  int count = 0;
  if (i < n) {
    const uint32_t rw = static_cast<uint32_t>(rect_word[i]);
    const int min_tx = rw & 0x3FFu;
    const int min_ty = (rw >> 10) & 0x3FFu;
    const int rect_w = (rw >> 20) & 0x3FFu;
    const int rh = rect_h[i];
    const bool culled0 = (rw & GSM_CULLED_BIT) != 0;
    uint32_t mask;
    if constexpr (kMode == kWarped) {
      mask = warped_window_mask(W, i, min_tx, min_ty, rect_w, rh, sb, lod_min,
                                theta_unit, inv255);
    } else {
      mask = window_mask<words_of<kMode>()>(W, i, min_tx, min_ty, rect_w, rh,
                                            tau, theta_unit, inv255);
    }
    const int cnt = __popc(mask);
    const bool visible = !culled0;
    const bool eligible = visible && rect_w <= GSM_MASK_W && rh <= GSM_MASK_H;
    if (count_rows) {
      count = (visible && !eligible) ? rh : 1;
    } else {
      count = visible ? (eligible ? cnt : rect_w * rh) : 0;
    }
    const bool culled = culled0 || (eligible && cnt == 0);
    const uint32_t ro = rw | (eligible ? GSM_MASKED_BIT : 0u) |
                        (culled ? GSM_CULLED_BIT : 0u);
    count = max(count, 1);
    rect_out[i] = static_cast<int32_t>(ro);
    mask_out[i] = static_cast<int32_t>(mask);
  }
  int block_total;
  const int excl = block_exclusive_scan<kPrepThreads>(count, &block_total);
  if (i < n) offsets[i] = excl;
  if (threadIdx.x == 0) block_sums[blockIdx.x] = block_total;
}

// One block: exclusive scan of the block sums in place (chunks of 1024 with
// a running carry) and offsets[n] = the grand total.
__global__ void scan_block_sums_kernel(int32_t* __restrict__ block_sums,
                                       int n_blocks,
                                       int32_t* __restrict__ offsets, int n) {
  int carry = 0;
  for (int base = 0; base < n_blocks; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const int v = j < n_blocks ? block_sums[j] : 0;
    int chunk_total;
    const int excl = block_exclusive_scan<kScanThreads>(v, &chunk_total);
    if (j < n_blocks) block_sums[j] = carry + excl;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) offsets[n] = carry;
}

__global__ void add_block_offsets_kernel(const int32_t* __restrict__ block_offs,
                                         int32_t* __restrict__ offsets, int n) {
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  if (i < n) offsets[i] += block_offs[blockIdx.x];
}

// Scan pass 2 and 3 after a kernel that left per-thread exclusive prefixes
// in offsets[0, n) and the block sums in block_sums.
void finish_scan(int32_t* offsets, int n, int32_t* block_sums, int n_blocks,
                 cudaStream_t stream) {
  scan_block_sums_kernel<<<1, kScanThreads, 0, stream>>>(
      block_sums, n > 0 ? n_blocks : 0, offsets, n);
  if (n > 0) {
    add_block_offsets_kernel<<<n_blocks, kPrepThreads, 0, stream>>>(
        block_sums, offsets, n);
  }
}

// Widened tile-column span [t_lo, t_lo + span) of the record's ellipse
// within tile row ty (kernels/expand.py::_row_tile_span, formula for
// formula).  span 0 when the ellipse misses the row or op < tau.
__device__ __forceinline__ void row_span(uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, int ty, int min_tx,
                                         int rect_w, float tau,
                                         float theta_unit, float inv255,
                                         int* t_lo_out, int* span_out) {
  const float mx = f16_bits_to_f32(a0);
  const float my = f16_bits_to_f32(a0 >> 16);
  const float theta =
      static_cast<float>(static_cast<int>(a1 & 0xFFFFu)) * theta_unit;
  const float s1 = jmax(f16_bits_to_f32(a1 >> 16), 1e-4f);
  const float s2 = jmax(f16_bits_to_f32(a2), 1e-4f);
  const float c = cosf(theta);
  const float s = sinf(theta);
  const float iv1 = 1.0f / (s1 * s1);
  const float iv2 = 1.0f / (s2 * s2);
  const float ca = c * c * iv1 + s * s * iv2;
  const float cb = c * s * (iv1 - iv2);
  const float det = iv1 * iv2;
  const float k = d2_cutoff(u8f(a3, 24, inv255), tau);

  const float y0 = static_cast<float>(ty) * 16.0f - my;
  const float y1 = y0 + 16.0f;
  const float cak = ca * k;
  const float ylim = sqrtf(jmax(cak / det, 0.0f));
  const float yc0 = jmax(y0, -ylim);
  const float yc1 = jmin(y1, ylim);
  const bool empty = (k < 0.0f) || (yc0 > yc1);

  const float inv_ca = 1.0f / jmax(ca, 1e-20f);
  const float t_mag = sqrtf(jmax(cak / (det * (det + cb * cb)), 0.0f));
  const float yb = jclip(-cb * t_mag, yc0, yc1);
  const float ya = jclip(cb * t_mag, yc0, yc1);
  const float db = sqrtf(jmax(cak - det * yb * yb, 0.0f));
  const float da = sqrtf(jmax(cak - det * ya * ya, 0.0f));
  const float xb = (-cb * yb + db) * inv_ca;
  const float xa = (-cb * ya - da) * inv_ca;
  const float pad = 1e-5f * (fabsf(xa) + fabsf(xb)) + 0.125f;
  const float xs0 = xa + mx - pad;
  const float xs1 = xb + mx + pad;
  int t_lo = static_cast<int>(floorf(xs0 * 0.0625f));
  int t_hi = static_cast<int>(floorf(xs1 * 0.0625f));
  t_lo = max(t_lo, min_tx);
  t_hi = min(t_hi, min_tx + rect_w - 1);
  *t_lo_out = t_lo;
  *span_out = empty ? 0 : max(t_hi - t_lo + 1, 0);
}

// planes: (7, r_cap) = rect', mask, dsw, w0..w3 of each row.
__global__ void row_expand_kernel(const int32_t* __restrict__ off1,
                                  const int32_t* __restrict__ rect1,
                                  const int32_t* __restrict__ mask1,
                                  const int32_t* __restrict__ dsw1, WordPtrs W,
                                  int n, int r_cap, float tau,
                                  float theta_unit, float inv255,
                                  int32_t* __restrict__ off2,
                                  int32_t* __restrict__ planes,
                                  int32_t* __restrict__ block_sums) {
  const int r = blockIdx.x * kPrepThreads + threadIdx.x;
  int count = 0;
  if (r < r_cap) {
    uint32_t rect2 = 0, mask = 0, dsw = 0, a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    if (r < off1[n]) {
      const int g = upper_bound_entry(off1, n, r);
      const int jj = r - off1[g];
      const uint32_t ru = static_cast<uint32_t>(rect1[g]);
      mask = static_cast<uint32_t>(mask1[g]);
      dsw = static_cast<uint32_t>(dsw1[g]);
      a0 = word(W, 0, g);
      a1 = word(W, 1, g);
      a2 = word(W, 2, g);
      a3 = word(W, 3, g);
      const bool culled = (ru & GSM_CULLED_BIT) != 0;
      const bool masked = (ru & GSM_MASKED_BIT) != 0;
      const int min_tx = ru & 0x3FFu;
      const int min_ty = (ru >> 10) & 0x3FFu;
      const int rect_w = (ru >> 20) & 0x3FFu;
      const int ty = min_ty + jj;
      int t_lo, span;
      row_span(a0, a1, a2, a3, ty, min_tx, rect_w, tau, theta_unit, inv255,
               &t_lo, &span);
      const bool passthrough = masked || culled;
      const bool empty = !passthrough && span == 0;
      rect2 = passthrough ? ru
                          : (static_cast<uint32_t>(t_lo) |
                             (static_cast<uint32_t>(ty) << 10) |
                             (static_cast<uint32_t>(span) << 20));
      if (empty) rect2 |= GSM_CULLED_BIT;
      count = (culled || empty) ? 1 : (masked ? __popc(mask) : span);
    }
    const size_t R = static_cast<size_t>(r_cap);
    planes[0 * R + r] = static_cast<int32_t>(rect2);
    planes[1 * R + r] = static_cast<int32_t>(mask);
    planes[2 * R + r] = static_cast<int32_t>(dsw);
    planes[3 * R + r] = static_cast<int32_t>(a0);
    planes[4 * R + r] = static_cast<int32_t>(a1);
    planes[5 * R + r] = static_cast<int32_t>(a2);
    planes[6 * R + r] = static_cast<int32_t>(a3);
  }
  int block_total;
  const int excl = block_exclusive_scan<kPrepThreads>(count, &block_total);
  if (r < r_cap) off2[r] = excl;
  if (threadIdx.x == 0) block_sums[blockIdx.x] = block_total;
}

__device__ __forceinline__ int nth_set_bit(uint32_t mask, int jj) {
  int p = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    const int cand = p + step;
    const uint32_t low = (1u << cand) - 1u;
    if (__popc(mask & low) <= jj) p = cand;
  }
  return p;
}

// minQuadRect of a record over the pixel rect [x0, x1] x [y0, y1].
__device__ __forceinline__ float rect_d2(uint32_t a0, uint32_t a1, uint32_t a2,
                                         float x0, float x1, float y0,
                                         float y1, float theta_unit) {
  const Conic k = decode_conic(a0, a1, a2, theta_unit);
  return d2min_rect(k, x0 - k.mx, x1 - k.mx, y0 - k.my, y1 - k.my);
}

// The CTA's first entry: the largest g in [0, n) with offsets[g] <= s0, for
// offsets[0] <= s0 < offsets[n].  A k-ary search: each round every thread
// probes one of kExpandThreads evenly spaced offsets and __syncthreads_count
// counts the probes at or below s0 (a prefix, the offsets being
// non-decreasing), which narrows [lo, hi) kExpandThreads + 1-fold: three
// rounds of one load each for a million entries.  Every thread of the block
// calls it and gets the same result.
__device__ __forceinline__ int block_upper_bound(const int32_t* offsets, int n,
                                                 int s0) {
  int lo = 0, hi = n;  // offsets[lo] <= s0 < offsets[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + kExpandThreads) / (kExpandThreads + 1);
    const int p = lo + (static_cast<int>(threadIdx.x) + 1) * step;
    const int below = __syncthreads_count(p < hi && offsets[p] <= s0);
    const int lo2 = lo + below * step;
    hi = min(lo2 + step, hi);
    lo = lo2;
  }
  return lo;
}

// out: (2, capacity) = key1, key2.  CTA b expands slots [b * kExpandSlots,
// (b + 1) * kExpandSlots); slot s0 + k * kExpandThreads + threadIdx.x is
// the thread's k-th.
template <int kMode>
__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ rect,
              const int32_t* __restrict__ mask,
              const int32_t* __restrict__ dsw, WordPtrs W, int n,
              int capacity, int tiles_x, int d_hi, int d_lo, int idx_bits,
              float tau, float theta_unit, float inv255,
              int32_t* __restrict__ out, const float* __restrict__ bounds) {
  __shared__ float sb[kMode == kWarped ? 2 * kBoundsLanes : 1];
  // the CTA's entries g0 + i, i <= kExpandSlots: their offsets (INT_MAX past
  // offsets[n]), rect, mask and depth word
  __shared__ int32_t s_off[kExpandSlots + 1], s_rect[kExpandSlots + 1],
      s_mask[kExpandSlots + 1], s_dsw[kExpandSlots + 1];
  if constexpr (kMode == kWarped) stage_bounds(bounds, sb);
  const int s0 = blockIdx.x * kExpandSlots;
  const int total = offsets[n];
  int g0 = 0;
  if (s0 < total) {
    g0 = block_upper_bound(offsets, n, s0);
    // Slot s0 + m lies in an entry <= g0 + m (g0 holds s0, and every entry
    // below the total owns >= 1 slot; a row table's dead tail, which
    // repeats the total, lies past them), so offsets[g0 + kExpandSlots] >
    // every live slot of the CTA and bounds the local search.
    for (int i = threadIdx.x; i <= kExpandSlots; i += kExpandThreads) {
      const int g = g0 + i;
      s_off[i] = g <= n ? offsets[g] : INT_MAX;
      if (g < n) {
        s_rect[i] = rect[g];
        s_mask[i] = mask[g];
        s_dsw[i] = dsw[g];
      }
    }
    __syncthreads();
  }
  const size_t C = static_cast<size_t>(capacity);
#pragma unroll
  for (int it = 0; it < kSlotsPerThread; ++it) {
    const int s = s0 + it * kExpandThreads + static_cast<int>(threadIdx.x);
    if (s >= capacity) break;
    uint32_t k1 = GSM_SENTINEL, k2 = GSM_SENTINEL;
    if (s < total) {
      int lo = 0, hi = kExpandSlots;  // s_off[lo] <= s < s_off[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= s) lo = mid; else hi = mid;
      }
      const int g = g0 + lo;
      const int jj = s - s_off[lo];
      const uint32_t rw = static_cast<uint32_t>(s_rect[lo]);
      const int min_tx = rw & 0x3FFu;
      const int min_ty = (rw >> 10) & 0x3FFu;
      const int rect_w = max(static_cast<int>((rw >> 20) & 0x3FFu), 1);
      int tx, ty;
      const bool masked = (rw & GSM_MASKED_BIT) != 0;
      if (masked) {
        const int pbit = nth_set_bit(static_cast<uint32_t>(s_mask[lo]), jj);
        ty = min_ty + (pbit >> 3);
        tx = min_tx + (pbit & 7);
      } else {
        const int q = jj / rect_w;
        ty = min_ty + q;
        tx = min_tx + (jj - q * rect_w);
      }
      bool dead = (rw & GSM_CULLED_BIT) != 0;
      // the exact test, and the words it reads, only where it decides:
      // every live slot under the warp (no bypass for MASKED entries),
      // else the unmasked ones
      if (!dead && (kMode == kWarped || !masked)) {
        const uint32_t a0 = word(W, 0, g), a1 = word(W, 1, g),
                       a2 = word(W, 2, g);
        bool passes;
        if constexpr (kMode == kMono) {
          const float x0 = static_cast<float>(tx) * 16.0f;
          const float y0 = static_cast<float>(ty) * 16.0f;
          passes = rect_d2(a0, a1, a2, x0, x0 + 16.0f, y0, y0 + 16.0f,
                           theta_unit) <=
                   d2_cutoff(u8f(word(W, 3, g), 24, inv255), tau);
        } else {
          const uint32_t b0 = word(W, 4, g), b1 = word(W, 5, g),
                         b2 = word(W, 6, g);
          float x0, x1, y0, y1;
          if constexpr (kMode == kWarped) {
            x0 = bound_at(sb, tx);
            x1 = bound_at(sb, tx + 1);
            y0 = bound_at(sb + kBoundsLanes, ty);
            y1 = bound_at(sb + kBoundsLanes, ty + 1);
          } else {
            x0 = static_cast<float>(tx) * 16.0f;
            y0 = static_cast<float>(ty) * 16.0f;
            x1 = x0 + 16.0f;
            y1 = y0 + 16.0f;
          }
          passes = jmin(rect_d2(a0, a1, a2, x0, x1, y0, y1, theta_unit),
                        rect_d2(b0, b1, b2, x0, x1, y0, y1, theta_unit)) <=
                   kStereoR2Cutoff;
        }
        dead = !passes;
      }
      if (!dead) {
        const uint32_t tile = static_cast<uint32_t>(ty * tiles_x + tx);
        const uint32_t dn = static_cast<uint32_t>(s_dsw[lo]);
        k1 = (tile << d_hi) | (dn >> d_lo);
        const uint32_t dlo = d_lo > 0 ? (dn & ((1u << d_lo) - 1u)) : 0u;
        k2 = (idx_bits < 32 ? (dlo << idx_bits) : 0u) | static_cast<uint32_t>(g);
      }
    }
    out[s] = static_cast<int32_t>(k1);
    out[C + s] = static_cast<int32_t>(k2);
  }
}

}  // namespace

// Mode of a launch: warped when a bounds table is given (8 words), else
// mono (4 words) or stereo (8 words); -1 for a word count the mode does not
// carry.
static int launch_mode(int n_words, const float* bounds) {
  if (bounds != nullptr) return n_words == 8 ? kWarped : -1;
  return n_words == 4 ? kMono : n_words == 8 ? kStereo : -1;
}

// bounds: the (2, 128) table for mode "warped", else null.
extern "C" int gsm_prep(const int32_t* rect_word, const int32_t* rect_h,
                        const void* const* words, int n_words, int count_rows,
                        int n, float tau, float theta_unit, float inv255,
                        int32_t* offsets, int32_t* rect_out, int32_t* mask_out,
                        int32_t* block_sums, int n_blocks,
                        const float* bounds, float lod_min,
                        cudaStream_t stream) {
  const int mode = launch_mode(n_words, bounds);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  const WordPtrs W = load_words(words, n_words);
  if (n > 0) {
    auto kernel = mode == kWarped   ? prep_kernel<kWarped>
                  : mode == kStereo ? prep_kernel<kStereo>
                                    : prep_kernel<kMono>;
    kernel<<<n_blocks, kPrepThreads, 0, stream>>>(
        rect_word, rect_h, W, count_rows, n, tau, theta_unit, inv255, offsets,
        rect_out, mask_out, block_sums, bounds, lod_min);
  }
  finish_scan(offsets, n, block_sums, n_blocks, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsm_row_expand(const int32_t* off1, const int32_t* rect1,
                              const int32_t* mask1, const int32_t* dsw1,
                              const void* const* words, int n, int r_cap,
                              float tau, float theta_unit, float inv255,
                              int32_t* off2, int32_t* planes,
                              int32_t* block_sums, int n_blocks,
                              cudaStream_t stream) {
  const WordPtrs W = load_words(words, 4);  // mono records
  if (r_cap > 0) {
    row_expand_kernel<<<n_blocks, kPrepThreads, 0, stream>>>(
        off1, rect1, mask1, dsw1, W, n, r_cap, tau, theta_unit, inv255, off2,
        planes, block_sums);
  }
  finish_scan(off2, r_cap, block_sums, n_blocks, stream);
  return static_cast<int>(cudaGetLastError());
}

// out: (2, capacity) = key1, key2; bounds: the (2, 128) table for mode
// "warped", else null.
extern "C" int gsm_expand(const int32_t* offsets, const int32_t* rect,
                          const int32_t* mask, const int32_t* dsw,
                          const void* const* words, int n_words, int n,
                          int capacity, int tiles_x, int d_hi, int d_lo,
                          int idx_bits, float tau, float theta_unit,
                          float inv255, int32_t* out, const float* bounds,
                          cudaStream_t stream) {
  const int mode = launch_mode(n_words, bounds);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  const WordPtrs W = load_words(words, n_words);
  if (capacity > 0) {
    const int blocks = (capacity + kExpandSlots - 1) / kExpandSlots;
    auto kernel = mode == kWarped   ? expand_kernel<kWarped>
                  : mode == kStereo ? expand_kernel<kStereo>
                                    : expand_kernel<kMono>;
    kernel<<<blocks, kExpandThreads, 0, stream>>>(
        offsets, rect, mask, dsw, W, n, capacity, tiles_x, d_hi, d_lo,
        idx_bits, tau, theta_unit, inv255, out, bounds);
  }
  return static_cast<int>(cudaGetLastError());
}

// bounds (2, 128); out (14, n): the 9 fx planes, then the 5 fy planes.
extern "C" int gsm_bounds_gather(const float* bounds, const int32_t* min_tx,
                                 const int32_t* min_ty, int n, float* out,
                                 cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    bounds_gather_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        bounds, min_tx, min_ty, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
