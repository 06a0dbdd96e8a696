// The instance sort of the KeyPlan frames, on the int64 keys alone: the key
// pack, CUB's keys-only radix sort and the tile ranges.  They are the device
// passes over the C instance slots between the expand's two key planes and
// the blend's (sorted key, starts, counts).
//
// The JAX package sorts the (key1, key2) pair with jax.lax.sort and finds
// the tile ranges with an XLA searchsorted (gsm_renderer_tpu/pipelines/
// common.py); neither is a Pallas kernel.  The sort stays a library sort
// here too (CUB, as torch.sort is), called keys-only: torch.sort of an int64
// tensor always sorts (key, index) pairs, and the blend reads each rank's
// entry through the key's low bits, so the indices were dead weight.  The
// pack and the ranges replace nine PyTorch launches with two kernels.
//
// Only the bits above the index field order anything.  Within one tile the
// expand writes live slots in strictly rising entry index (an entry owns at
// most one slot a tile, and slots follow the entries' prefix offsets), and
// CUB's LSD radix sort is stable, so sorting from the first depth bit up
// puts every slot at the rank the full 64-bit sort gives it.  The KeyPlan's
// key2 is [gap | depth_lo | index] with a zero gap of lift = 32 - d_lo -
// idx_bits bits, so the pack lifts depth_lo over the gap to the top of the
// low word, the index staying in its low idx_bits: the ordering bits are
// then the one run [32 - d_lo, 64), which the sort takes as its begin bit
// (the garden's plan: 40 bits, 5 passes of 8 where the whole key takes 8).
// A lift of 0 and a begin bit of 0 are the plain (key1, key2) key and its
// full sort (the stable fallback's pack).
//
// All three are bound by device memory.  At C slots: the pack reads 8 B and
// writes 8 B a slot; the sort makes one pass per 8 key bits it sorts, each
// reading and writing the 8-B keys (16 B a slot a pass: half what the pairs
// sort moves); the ranges read 8 B a slot and write 4 B a tile.
//
// The ranges' counts pass also clamps each tile's count to the frame's
// max_per_tile, where one is set (the Local frames' nearest instances a
// tile), and writes the sum of the counts it writes beside them: the frame
// header's total_instances.  The boundary pass zeroes that sum, and each
// block of the counts pass adds its own with one atomicAdd, so the sum
// takes no launch of its own and no memset.

#include <cub/device/device_radix_sort.cuh>

#include "common.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kRangeThreads = 256;

// The int64 key whose signed order is the unsigned (key1, key2') order
// (kernels/sort.py::sort_key64): bit 31 of key1 flipped, so that the
// sentinel and the upper tile ids sort last under the signed compare; key2'
// is key2 with its bits above the index (idx_mask) moved up by lift (the
// sentinel keeps its index bits and the top d_lo bits set).
__device__ __forceinline__ long long pack_key(int32_t k1, int32_t k2,
                                              uint32_t idx_mask, int lift) {
  const uint32_t lo = static_cast<uint32_t>(k2);
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<uint32_t>(k1) ^
                                       0x80000000u) << 32) |
      ((lo & idx_mask) | ((lo & ~idx_mask) << lift)));
}

// The pack (replaces sort_key64's five int64 launches: &, a copy, |, ^,
// <<).  Bound: 16 B a slot of device memory, so a thread moves four slots
// with two 16-B loads and two 16-B stores where both planes are 16-B aligned
// (key2 is the second row of the expand's (2, C) output: aligned when C is a
// multiple of 4), and one slot at a time otherwise and at the tail.
__global__ void __launch_bounds__(kPackThreads)
    sort_key_pack_kernel(const int32_t* __restrict__ key1,
                         const int32_t* __restrict__ key2, int n,
                         uint32_t idx_mask, int lift, int vec,
                         long long* __restrict__ out) {
  const long long i =
      4LL * (static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x);
  if (i >= n) {
    return;
  }
  if (vec && i + 4 <= n) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(key1 + i));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(key2 + i));
    longlong2* o = reinterpret_cast<longlong2*>(out + i);
    o[0] = make_longlong2(pack_key(a.x, b.x, idx_mask, lift),
                          pack_key(a.y, b.y, idx_mask, lift));
    o[1] = make_longlong2(pack_key(a.z, b.z, idx_mask, lift),
                          pack_key(a.w, b.w, idx_mask, lift));
    return;
  }
  const long long end = i + 4 < n ? i + 4 : n;
  for (long long j = i; j < end; ++j) {
    out[j] = pack_key(key1[j], key2[j], idx_mask, lift);
  }
}

// The tile of a sorted key: num_tiles for the sentinel (a dead slot) and
// for any tile id at or past num_tiles, else key1 >> shift (shift: the
// KeyPlan's d_hi, or 0 for the stable fallback's plain tile key).  Rising
// with the key, so the sorted keys' tiles rise too.
__device__ __forceinline__ int tile_of(long long key, int shift,
                                       int num_tiles) {
  const uint32_t k1 =
      static_cast<uint32_t>(static_cast<unsigned long long>(key) >> 32) ^
      0x80000000u;
  if (k1 == GSM_SENTINEL) {
    return num_tiles;
  }
  const uint32_t t = k1 >> shift;
  return t < static_cast<uint32_t>(num_tiles) ? static_cast<int>(t)
                                              : num_tiles;
}

// The tile boundaries (replaces binning_sorted_tile's four int64 launches,
// the arange and torch.searchsorted): bounds[b] is the first slot whose tile
// is b or more, for b in [0, num_tiles], C where there is none.  Thread i of
// 0..C compares slot i's tile t with slot i - 1's, t_prev (-1 before slot
// 0; slot C counts as tile num_tiles), and writes i to every boundary in
// (t_prev, t]: each boundary is written once, by the slot where the tiles
// first reach it.  A warp loads its 32 keys once and passes each tile to the
// next lane by a shuffle; only lane 0 reads the key before it.  Bound: the
// 8-B keys read once.  A run of G empty tiles costs one thread G stores (a
// frame with no live slot: num_tiles + 1 from thread 0).
__global__ void __launch_bounds__(kRangeThreads)
    sort_ranges_kernel(const long long* __restrict__ keys, int n,
                       int num_tiles, int shift, int32_t* __restrict__ bounds,
                       int32_t* __restrict__ total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kRangeThreads + threadIdx.x;
  if (i == 0) {
    *total = 0;  // the counts pass adds to it
  }
  const int t = i < n ? tile_of(keys[i], shift, num_tiles) : num_tiles;
  int t_prev = __shfl_up_sync(0xFFFFFFFFu, t, 1);
  if ((threadIdx.x & 31) == 0) {
    t_prev = i == 0 ? -1
             : i - 1 < n ? tile_of(keys[i - 1], shift, num_tiles)
                         : num_tiles;
  }
  if (i <= n) {
    for (int b = t_prev + 1; b <= t; ++b) {
      bounds[b] = static_cast<int32_t>(i);
    }
  }
}

// counts[t] = bounds[t + 1] - bounds[t], at most max_per_tile where that is
// above 0, and *total += the block's sum of them: a second launch, after
// every boundary is written and *total zeroed.
__global__ void __launch_bounds__(kRangeThreads)
    sort_ranges_counts_kernel(const int32_t* __restrict__ bounds,
                              int num_tiles, int max_per_tile,
                              int32_t* __restrict__ counts,
                              int32_t* __restrict__ total) {
  __shared__ int s_sum[kRangeThreads / 32];
  const int t = blockIdx.x * kRangeThreads + threadIdx.x;
  int c = 0;
  if (t < num_tiles) {
    c = bounds[t + 1] - bounds[t];
    if (max_per_tile > 0) {
      c = min(c, max_per_tile);
    }
    counts[t] = c;
  }
  const int warp_sum = __reduce_add_sync(0xFFFFFFFFu, c);
  if ((threadIdx.x & 31) == 0) {
    s_sum[threadIdx.x >> 5] = warp_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kRangeThreads / 32; ++w) {
      sum += s_sum[w];
    }
    atomicAdd(total, sum);
  }
}

}  // namespace

// The pack of n slots of the expand's key planes into out (int64), key2's
// bits above its low idx_bits lifted by lift (0: the plain key).
extern "C" int gsm_sort_key_pack(const int32_t* key1, const int32_t* key2,
                                 int n, int idx_bits, int lift,
                                 long long* out, cudaStream_t stream) {
  if (n < 0 || idx_bits < 0 || idx_bits > 32 || lift < 0 || lift > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t idx_mask =
      idx_bits == 32 ? 0xFFFFFFFFu : (1u << idx_bits) - 1u;
  if (n > 0) {
    const int vec = ((reinterpret_cast<uintptr_t>(key1) |
                      reinterpret_cast<uintptr_t>(key2) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const long long quads = (static_cast<long long>(n) + 3) / 4;
    const int blocks =
        static_cast<int>((quads + kPackThreads - 1) / kPackThreads);
    sort_key_pack_kernel<<<blocks, kPackThreads, 0, stream>>>(
        key1, key2, n, idx_mask, lift, vec, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The temporary storage, in bytes, of gsm_sort_keys over n keys from
// begin_bit up.  Host code: launches nothing.
extern "C" int gsm_sort_keys_temp_bytes(int n, int begin_bit, size_t* bytes) {
  cub::DoubleBuffer<int64_t> keys(nullptr, nullptr);
  *bytes = 0;
  if (begin_bit < 0 || begin_bit > 63) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      cub::DeviceRadixSort::SortKeys(nullptr, *bytes, keys, n, begin_bit, 64));
}

// CUB's keys-only LSD radix sort of the n int64 keys in keys over bits
// [begin_bit, 64): keys equal in those bits keep their order (the sort is
// stable); one pass per 8 bits.  It ping-pongs between keys and alt (both
// overwritten); *selector is set to 1 where the sorted keys end in alt, 0
// where in keys (an odd pass count ends in alt).  temp:
// gsm_sort_keys_temp_bytes(n, begin_bit) bytes (a null temp would make CUB
// only size it).  The one key type is instantiated, so that the build
// stays short.
extern "C" int gsm_sort_keys(int64_t* keys, int64_t* alt, int n, void* temp,
                             size_t temp_bytes, int begin_bit, int* selector,
                             cudaStream_t stream) {
  *selector = 0;
  if (n < 0 || (n > 0 && temp == nullptr) || begin_bit < 0 ||
      begin_bit > 63) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    cub::DoubleBuffer<int64_t> buf(keys, alt);
    const cudaError_t err = cub::DeviceRadixSort::SortKeys(
        temp, temp_bytes, buf, n, begin_bit, 64, stream);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    *selector = buf.selector;
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile ranges of n sorted int64 keys over num_tiles tiles: bounds
// (num_tiles + 1, int32; starts are its first num_tiles) and counts
// (num_tiles + 1, int32: each tile's count, at most max_per_tile where that
// is above 0, then their sum).  Two launches.
extern "C" int gsm_sort_ranges(const long long* keys, int n, int num_tiles,
                               int shift, int max_per_tile, int32_t* bounds,
                               int32_t* counts, cudaStream_t stream) {
  if (n < 0 || num_tiles < 1 || shift < 0 || shift > 31 ||
      max_per_tile < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = static_cast<long long>(n) + 1;
  const int blocks =
      static_cast<int>((threads + kRangeThreads - 1) / kRangeThreads);
  sort_ranges_kernel<<<blocks, kRangeThreads, 0, stream>>>(
      keys, n, num_tiles, shift, bounds, counts + num_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  sort_ranges_counts_kernel<<<(num_tiles + kRangeThreads - 1) / kRangeThreads,
                              kRangeThreads, 0, stream>>>(
      bounds, num_tiles, max_per_tile, counts, counts + num_tiles);
  return static_cast<int>(cudaGetLastError());
}
