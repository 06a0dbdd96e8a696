// Kernels 2 and 3: binning prep and slot expansion (mono, KeyPlan keys).
//
// Kernel 2 replaces the Pallas kernel gsm_renderer_tpu/kernels/expand.py::
// _prep_kernel (binning_prep_pallas, mode "mono", count_rows=False): per
// gaussian, the exact 8x4 tile mask (up to 32 minQuadRect <= d2 cutoff
// tests), its popcount, the MASKED / CULLED bits and the instance count
// (every gaussian owns >= 1 slot); then the global exclusive scan of the
// counts.  The Pallas kernel carries the scan across its sequential grid in
// SMEM; blocks here run in no order, so the scan is three passes written by
// hand: a block scan (warp shuffles) that also stores each block's sum, one
// block that scans the block sums and writes offsets[n] (the slot total),
// and an add-back of the block offsets.
//
// Kernel 3 replaces _expand_kernel (expand_slots_pallas with a prebuilt
// table and a KeyPlan): one thread per slot.  The owning gaussian is an
// upper-bound binary search over the strictly increasing offsets; the tile
// is the j-th set bit of the mask (MASKED gaussians) or the row-major walk
// of the rect plus the exact tile test.  Keys: key1 = [tile | depth_hi],
// key2 = [depth_lo | gaussian index]; dead slots (slot >= total, culled
// gaussian, failed test) get the sentinel in both keys and zero words.
// Slots at or beyond the capacity are not written (the grid covers the
// capacity); the caller derives overflow = total > capacity.
//
// Bounds on the H100.  Prep: float operations (32 tests of ~65 flops for a
// gaussian whose rect fills the window) against 36 B of traffic per
// gaussian.  Expand: device memory (24 B written per slot, ~36 B read per
// gaussian); the binary search's 20 dependent loads hit L2 (the offsets of
// 1M gaussians are 4 MB).  Both are one thread per element, coalesced.
#include "common.cuh"

namespace {

constexpr int kPrepThreads = 256;
constexpr int kScanThreads = 1024;

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

__global__ void prep_kernel(const int32_t* __restrict__ rect_word,
                            const int32_t* __restrict__ rect_h,
                            const int32_t* __restrict__ w0,
                            const int32_t* __restrict__ w1,
                            const int32_t* __restrict__ w2,
                            const int32_t* __restrict__ w3, int n, float tau,
                            float theta_unit, float inv255,
                            int32_t* __restrict__ offsets,
                            int32_t* __restrict__ rect_out,
                            int32_t* __restrict__ mask_out,
                            int32_t* __restrict__ block_sums) {
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  int count = 0;
  if (i < n) {
    const uint32_t rw = static_cast<uint32_t>(rect_word[i]);
    const int min_tx = rw & 0x3FFu;
    const int min_ty = (rw >> 10) & 0x3FFu;
    const int rect_w = (rw >> 20) & 0x3FFu;
    const int rh = rect_h[i];
    const bool culled0 = (rw & GSM_CULLED_BIT) != 0;
    const uint32_t a0 = static_cast<uint32_t>(w0[i]);
    const uint32_t a1 = static_cast<uint32_t>(w1[i]);
    const uint32_t a2 = static_cast<uint32_t>(w2[i]);
    const uint32_t a3 = static_cast<uint32_t>(w3[i]);
    const Conic k = decode_conic(a0, a1, a2, theta_unit);
    const float cutoff = d2_cutoff(u8f(a3, 24, inv255), tau);
    const float x_base = static_cast<float>(min_tx) * 16.0f - k.mx;
    const float y_base = static_cast<float>(min_ty) * 16.0f - k.my;
    uint32_t mask = 0;
    for (int dy = 0; dy < GSM_MASK_H && dy < rh; ++dy) {
      const float ymin = y_base + static_cast<float>(dy * 16);
      for (int dx = 0; dx < GSM_MASK_W && dx < rect_w; ++dx) {
        const float xmin = x_base + static_cast<float>(dx * 16);
        const float d2 = d2min_rect(k, xmin, xmin + 16.0f, ymin, ymin + 16.0f);
        if (d2 <= cutoff) mask |= 1u << (dy * GSM_MASK_W + dx);
      }
    }
    const int cnt = __popc(mask);
    const bool visible = !culled0;
    const bool eligible = visible && rect_w <= GSM_MASK_W && rh <= GSM_MASK_H;
    count = visible ? (eligible ? cnt : rect_w * rh) : 0;
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

__global__ void expand_kernel(const int32_t* __restrict__ offsets,
                              const int32_t* __restrict__ rect,
                              const int32_t* __restrict__ mask,
                              const int32_t* __restrict__ dsw,
                              const int32_t* __restrict__ w0,
                              const int32_t* __restrict__ w1,
                              const int32_t* __restrict__ w2,
                              const int32_t* __restrict__ w3, int n,
                              int capacity, int tiles_x, int d_hi, int d_lo,
                              int idx_bits, float tau, float theta_unit,
                              float inv255, int32_t* __restrict__ key1,
                              int32_t* __restrict__ key2,
                              int32_t* __restrict__ o0, int32_t* __restrict__ o1,
                              int32_t* __restrict__ o2,
                              int32_t* __restrict__ o3) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= capacity) return;
  const int total = offsets[n];
  bool dead = s >= total;
  uint32_t k1 = GSM_SENTINEL, k2 = GSM_SENTINEL;
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (!dead) {
    int lo = 0, hi = n;  // offsets[lo] <= s < offsets[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offsets[mid] <= s) lo = mid; else hi = mid;
    }
    const int g = lo;
    const int jj = s - offsets[g];
    const uint32_t rw = static_cast<uint32_t>(rect[g]);
    const int min_tx = rw & 0x3FFu;
    const int min_ty = (rw >> 10) & 0x3FFu;
    const int rect_w = max(static_cast<int>((rw >> 20) & 0x3FFu), 1);
    a0 = static_cast<uint32_t>(w0[g]);
    a1 = static_cast<uint32_t>(w1[g]);
    a2 = static_cast<uint32_t>(w2[g]);
    a3 = static_cast<uint32_t>(w3[g]);
    int tx, ty;
    bool passes;
    if (rw & GSM_MASKED_BIT) {
      const int pbit = nth_set_bit(static_cast<uint32_t>(mask[g]), jj);
      ty = min_ty + (pbit >> 3);
      tx = min_tx + (pbit & 7);
      passes = true;
    } else {
      const int q = jj / rect_w;
      ty = min_ty + q;
      tx = min_tx + (jj - q * rect_w);
      const Conic k = decode_conic(a0, a1, a2, theta_unit);
      const float x0 = static_cast<float>(tx) * 16.0f;
      const float y0 = static_cast<float>(ty) * 16.0f;
      const float d2 = d2min_rect(k, x0 - k.mx, (x0 + 16.0f) - k.mx,
                                  y0 - k.my, (y0 + 16.0f) - k.my);
      passes = d2 <= d2_cutoff(u8f(a3, 24, inv255), tau);
    }
    dead = (rw & GSM_CULLED_BIT) || !passes;
    if (!dead) {
      const uint32_t tile = static_cast<uint32_t>(ty * tiles_x + tx);
      const uint32_t dn = static_cast<uint32_t>(dsw[g]);
      k1 = (tile << d_hi) | (dn >> d_lo);
      const uint32_t dlo = d_lo > 0 ? (dn & ((1u << d_lo) - 1u)) : 0u;
      k2 = (idx_bits < 32 ? (dlo << idx_bits) : 0u) | static_cast<uint32_t>(g);
    } else {
      a0 = a1 = a2 = a3 = 0;
    }
  }
  key1[s] = static_cast<int32_t>(k1);
  key2[s] = static_cast<int32_t>(k2);
  o0[s] = static_cast<int32_t>(a0);
  o1[s] = static_cast<int32_t>(a1);
  o2[s] = static_cast<int32_t>(a2);
  o3[s] = static_cast<int32_t>(a3);
}

}  // namespace

extern "C" int gsm_prep(const int32_t* rect_word, const int32_t* rect_h,
                        const int32_t* w0, const int32_t* w1,
                        const int32_t* w2, const int32_t* w3, int n, float tau,
                        float theta_unit, float inv255, int32_t* offsets,
                        int32_t* rect_out, int32_t* mask_out,
                        int32_t* block_sums, int n_blocks,
                        cudaStream_t stream) {
  if (n > 0) {
    prep_kernel<<<n_blocks, kPrepThreads, 0, stream>>>(
        rect_word, rect_h, w0, w1, w2, w3, n, tau, theta_unit, inv255, offsets,
        rect_out, mask_out, block_sums);
  }
  scan_block_sums_kernel<<<1, kScanThreads, 0, stream>>>(
      block_sums, n > 0 ? n_blocks : 0, offsets, n);
  if (n > 0) {
    add_block_offsets_kernel<<<n_blocks, kPrepThreads, 0, stream>>>(
        block_sums, offsets, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsm_expand(const int32_t* offsets, const int32_t* rect,
                          const int32_t* mask, const int32_t* dsw,
                          const int32_t* w0, const int32_t* w1,
                          const int32_t* w2, const int32_t* w3, int n,
                          int capacity, int tiles_x, int d_hi, int d_lo,
                          int idx_bits, float tau, float theta_unit,
                          float inv255, int32_t* key1, int32_t* key2,
                          int32_t* o0, int32_t* o1, int32_t* o2, int32_t* o3,
                          cudaStream_t stream) {
  if (capacity > 0) {
    const int threads = 256;
    const int blocks = (capacity + threads - 1) / threads;
    expand_kernel<<<blocks, threads, 0, stream>>>(
        offsets, rect, mask, dsw, w0, w1, w2, w3, n, capacity, tiles_x, d_hi,
        d_lo, idx_bits, tau, theta_unit, inv255, key1, key2, o0, o1, o2, o3);
  }
  return static_cast<int>(cudaGetLastError());
}
