// Binning kernels: prep (kernel 2), row expansion (kernel 3), slot
// expansion (kernel 4), the foveated bounds gather (kernel 7) and the
// foveated re-bin onto the physical tiles (see its note below), for the
// mono and full-rect "none" (4 record words), stereo and warped (8 words:
// the left record, then the right; w3 shared) tables with KeyPlan keys.
//
// Prep replaces the Pallas kernel gsm_renderer_tpu/kernels/expand.py::
// _prep_kernel (binning_prep_pallas, modes "mono", "stereo" and "warped",
// options count_rows and lod_min): per gaussian, the exact 8x4 tile mask
// (up to 32 minQuadRect tests: <= the alpha d2 cutoff in mono, either eye
// <= 9 in stereo and warped; warped tests the display-space rect of each
// physical tile and, with lod_min > 0, applies the periphery LOD drop), its
// popcount, the MASKED / CULLED bits and the count -- instances, or virtual
// tile rows under count_rows (every gaussian owns >= 1); then the global
// exclusive scan of the counts, offsets[n] the total.
//
// On the H100 prep is bound by issued instructions, not bytes (36-52 B a
// gaussian).  A gaussian needs min(rect_w, 8) * min(rect_h, 4) tests, 3.7
// on average in the 1M headline frame; a thread per gaussian looping over
// its own tests makes each warp run its longest lane's loop (11.2 tests on
// average, 3x the work), twice that in stereo.  So the tests are balanced
// across the warp, a gaussian a thread and 256 a block:
//   1. each lane loads its gaussian once, decodes its conic(s) and cutoff
//      (or LOD ink), computes the per-conic terms of minQuadRect once
//      (QuadRect), and stages them in its column of shared memory (mono 8
//      floats, stereo 14, warped 15 and the window corner);
//   2. the warp scans its lanes' test counts and walks the flattened list
//      of (gaussian, window position) tests 32 at a time (4 rounds in the
//      headline warp against 11.2 loop trips); a lane finds its test's
//      owner by a 5-step shuffle search over the scan, reads the owner's
//      staged record and runs one test, d2min_quad: d2min_rect's operations
//      with one-instruction NaN-propagating min / max, which pass or fail
//      every test as d2min_rect does (common.cuh);
//   3. a ballot of the round's results goes back to the owners: each owner
//      ORs its lanes' bits, in test order, into a register, and turns that
//      into the 8x4 window mask after the last round.
// Blocks of 1024 gaussians (four a thread) ran the dual-eye modes slower
// on the H100 (more registers, a quarter of the blocks) and mono no
// faster, so a thread preps one.
//
// Mode "none" (the Hardware renderer's full rects, exact_test=False) tests
// nothing: a visible gaussian counts its whole clamped rect, rect_w *
// rect_h, and a culled one a single dead slot (the JAX package's XLA
// binning_inputs, counts = max(rect_count, 1), and the cumsum of
// expand_slots_pallas).  Its prep reads the rect word and rect_h alone
// (8 B a gaussian), writes no mask and no MASKED bit, leaves the rect word
// as the projection wrote it and runs the same one-pass scan: it writes the
// offsets only.  Bound: device memory.
//
// The scan is one pass with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016),
// written here: a block takes its tile index from an atomic ticket (so every
// tile it waits on belongs to a block that has started), scans its counts,
// publishes its aggregate in a status word, walks back over its
// predecessors' words 32 at a time until it meets an inclusive prefix,
// publishes its own inclusive prefix and writes final offsets; the last
// tile writes offsets[n].  It replaces the block scans, the single block
// that walked all block sums in series and the add-back pass.
//
// Look-back state and its reset: the wrapper owns one scratch per device
// and stream, a ticket word (epoch << 32 | next tile) and a status word per
// tile (tag << 32 | value << 1 | is_prefix, tag = epoch + 1, never 0).  The
// block that draws the launch's last ticket sets the ticket word to the
// next epoch with the count 0: every ticket is out by then, and the next
// launch on the stream starts after this one ends.  A status word counts
// only when its tag is the launch's, so nothing is zeroed per call and the
// kernel is one launch.  Zeroed scratch reads as no status.  The epoch
// skips the value that would give tag 0; a status word of 2^32 - 1 launches
// ago would read as current if no launch since had reached its tile.
//
// The header's sums.  Every prep launch also writes the frame header's
// three sums over its gaussians into a record of three ints (sums): the
// visible count (the input rect word's CULLED bit clear: the projection's
// visibility), the visible rect total (rect_w * rect_h of each visible
// gaussian) and the row demand (rect_h for a visible rect wider than 8 or
// taller than 4 tiles, else 1), each modulo 2^32 as the int64 torch sums
// they replace, cut to int32, give them.  Mode band states the same terms of
// its band clamp (visible in the band, rect_w * rows in the band).  Each
// block reduces its gaussians' terms; while warp 0 looks back, lanes 0-2 of
// warp 1 add the block's three partials to three accumulator words beside
// the ticket, one 64-bit atomicAdd each of (partial << 24) + 1: the low 24
// bits count the blocks that arrived (at most 2^24 - 1, so no carry
// reaches the sum), the high 40 the sum.  The lane whose add finds every
// other block arrived holds the total, writes it and zeroes the word for
// the next launch on the stream, so, as for the status words, nothing is
// zeroed per call and the sums add no launch.  Under count_rows the row
// demand is the scan's own total, offsets[n]: the last tile writes it, and
// its word is not touched.  (That equals the row term's sum wherever a
// visible gaussian's rect_h is at least 1, as the projections write it.)
//
// Mode band (gsm_prep_band, the band-sharded frame's) replaces the JAX
// package's XLA band clamp (gsm_renderer_tpu/parallel/multichip.py:245-283
// with binning_inputs' mask_override) and the exclusive scan of
// expand_slots_pallas.  Its inputs are the planes gathered from every
// rank: the rect word, the rect rows (min_ty | max_ty << 10), the raw
// depth key (0xFFFFFFFF where culled) and the 8x4 mask.  A thread clamps
// its gaussian's rows to the band [band0, band1), rebases the mask to the
// clamp (mask >> 8 * clip(bty0 - min_ty, 0, 3), cut to the rows in the
// band), counts the sub-mask's popcount where the rect fits the window and
// rect_w * rows-in-band otherwise (one dead slot when culled or outside the
// band), writes the band-local rect word, the sub-mask and the depth word
// normalized under the band's KeyPlan, and scans like the other modes.  No
// test: bound by device memory (16 B read, 16 B written a gaussian).
//
// Row expansion replaces _row_expand_kernel (row_expand_pallas): row r < R
// belongs to the gaussian g with offsets[g] <= r < offsets[g + 1] (strictly
// increasing: every gaussian owns >= 1 row) and is its tile row jj = r -
// offsets[g]; an oversized rect's row is narrowed to the closed-form column
// span of the ellipse (row_span, the formulas of _row_tile_span), and the
// per-row instance counts go through the same one-pass scan, so the output
// is again a complete table of R entries plus offsets[R].  Rows at or past
// the row total carry zero planes and count 0.  Bound on the H100: device
// memory (~36 B read and 32 B written a row; only the oversized rows run
// the span's ~75 flops).  The first port searched 20 dependent loads of
// the offsets in device memory for every row.  Here a block of 2048 rows
// (eight a thread, strided so that writes coalesce) finds the gaussian of
// its first row with one k-ary search (block_upper_bound); its rows lie in
// the 2048 gaussians from there, whose offsets it stages in shared memory
// (8 KB), and each row searches 11 steps there and reads its gaussian's
// words from device memory (neighbouring rows mostly belong to neighbouring
// gaussians, so the reads coalesce).  Smaller blocks, and larger ones,
// were slower on the H100: the search, the staging and the look-back are
// paid once a block, and a larger block holds more registers.
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
// the caller derives overflow = total > capacity.  In mode "none" the
// expand reads no mask and no record word: every slot of a visible
// entry's rect is live (the Hardware frame's quads cover their whole rect,
// and its blend cuts each pixel at r^2 > 9 instead).  A band frame's mono
// expand runs its test at tile row ty + row_offset (the band's first row
// in the frame) and keys band-local tiles.  With plain_key (no tie-free
// KeyPlan fits: the stable fallback) key1 is the tile id, key2 the depth
// word, and a third plane holds the slot's entry index, which the sort
// carries to the blend (the JAX expand's plain key = tile).
//
// The expand is a load-balanced search.  CTA b owns the 1024 slots [1024 b,
// 1024 (b + 1)), four per thread, strided so that writes coalesce.  One
// k-ary search over the offsets in device memory (three rounds of one load
// a thread for a million entries) finds the entry g0 of its first slot; the
// CTA stages the offsets, rect, mask and depth word of entries g0 ..
// g0 + 1024 in shared memory (16 KB; they cover every slot of the CTA), and
// each slot finds its entry with a 10-step binary search there.  Record
// words are read from device memory (L1 serves neighbours) only where the
// exact test reads them.  Bound on the H100: device memory, 8 B written per
// slot (the two keys) and 16 B read per entry (offset, rect, mask, depth
// word) plus the words of the tested entries.
//
// Bounds gather replaces _bgather_kernel (warped_bounds_gather_pallas): one
// thread per gaussian reads the 9 x and 5 y display coordinates of the
// physical tile boundaries min_t + d of its window, bounds[axis][min(min_t +
// d, 127)], from the (2, 128) float table staged in shared memory (1 KB),
// and writes 14 planes (bound: device memory, 8 B read and 56 B written a
// gaussian).  The standalone kernel runs only for callers that want the
// planes: the warped prep reads the same entries (bound_at) from its own
// staged table per test, as the JAX production path fuses the gather.
//
// The warped modes read the bounds table from shared memory: every thread
// of the block stages part of it and passes one barrier before any thread
// leaves.
//
// Tiles: prep, the row expansion and the expand take tiles of tile_w x
// tile_h pixels, each side 1 to 4096 (tile_side_ok), in every mode, as
// runtime arguments.  The 8x4 window keeps its geometry in tiles; only the
// pixel extents of each test change (x0 = tx * tile_w, x1 = x0 + tile_w,
// y0 = ty * tile_h, y1 = y0 + tile_h, the window corner min_t * side and
// the offsets d * side, d < 8: a tile index below 1024, the rect word's
// 10-bit field, times a side of at most 4096 is an integer below 2^22, so
// exact in float32 at every side), and the row span divides by tile_w as
// a multiply by its float32 reciprocal (1.0f / tile_w, correctly rounded,
// which is the float32 rounding of the JAX kernel's 1.0 / tile_w at every
// side up to 4096).  The warped level of detail divides tile_w by the
// display width of the tile, as the JAX kernel does; its window rects are
// the bounds table's, whatever the side.  The sides only scale
// coordinates, so they are not template parameters: one instance a mode
// serves every geometry (a multiply by a register where a constant stood).
#include <climits>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kPrepThreads = 256;
constexpr int kRowThreads = 256;
constexpr int kRowItems = 8;  // rows a thread, strided by 256
constexpr int kRowTile = kRowThreads * kRowItems;
constexpr int kExpandThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kExpandSlots = kExpandThreads * kSlotsPerThread;
constexpr float kStereoR2Cutoff = 9.0f;
constexpr int kBoundsLanes = 128;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// Binning modes: the record words they carry and the test they apply
// (kernels/expand.py MODE_CODES).  kBand is a prep mode only: the band
// clamp of gathered planes (gsm_prep_band).
enum Mode { kMono = 0, kStereo = 1, kWarped = 2, kNone = 3, kBand = 4 };

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFullWarp, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Block-wide exclusive scan of kItems ints a thread in the order (item,
// thread): excl[k] = the sum of the values before (k, threadIdx.x); *total =
// the block's sum.  Three barriers for any kItems.
template <int kThreads, int kItems>
__device__ __forceinline__ void block_exclusive_scan(const int (&v)[kItems],
                                                     int (&excl)[kItems],
                                                     int* total) {
  constexpr int kWarps = kThreads / 32, kSums = kItems * kWarps;
  __shared__ int sums[kSums];  // warp totals, then their exclusive scan
  __shared__ int s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    inc[k] = warp_inclusive_scan(v[k]);
    if (lane == 31) sums[k * kWarps + warp] = inc[k];
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
#pragma unroll
    for (int c = 0; c < kSums; c += 32) {
      const int j = c + lane;
      const int x = j < kSums ? sums[j] : 0;
      const int xi = warp_inclusive_scan(x);
      if (j < kSums) sums[j] = carry + xi - x;
      carry += __shfl_sync(kFullWarp, xi, 31);
    }
    if (lane == 0) s_total = carry;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    excl[k] = sums[k * kWarps + warp] + inc[k] - v[k];
  }
  *total = s_total;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// One-pass scan with decoupled look-back (see the note at the top)
// ---------------------------------------------------------------------------

// The look-back scratch of a launch: the ticket word, the tile statuses
// and prep's three accumulators of the header's sums.
struct ScanState {
  unsigned long long* ticket;
  unsigned long long* status;
  unsigned long long* sums;
  int num_tiles;
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             uint32_t tag, int value,
                                             bool is_prefix) {
  const unsigned long long v =
      (static_cast<unsigned long long>(tag) << 32) |
      (static_cast<uint32_t>(value) << 1) | (is_prefix ? 1u : 0u);
  asm volatile("st.relaxed.gpu.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The block's tile, in the order blocks start; *tag = the launch's status
// tag.  Every thread calls it (it ends in a barrier).
__device__ __forceinline__ int take_tile(const ScanState& st, uint32_t* tag) {
  __shared__ int s_tile;
  __shared__ uint32_t s_tag;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(st.ticket, 1ull);
    const uint32_t epoch = static_cast<uint32_t>(t >> 32);
    const int tile = static_cast<int>(static_cast<uint32_t>(t));
    if (tile == st.num_tiles - 1) {
      // the last ticket: hand the word to the next launch
      const uint32_t next = epoch + 1u == 0xFFFFFFFFu ? 0u : epoch + 1u;
      atomicExch(st.ticket, static_cast<unsigned long long>(next) << 32);
    }
    s_tile = tile;
    s_tag = epoch + 1u;
  }
  __syncthreads();
  *tag = s_tag;
  return s_tile;
}

// Warp 0 of a block: publishes the tile's aggregate, finds the sum of the
// counts of every earlier tile from the predecessors' status words, and
// publishes the tile's inclusive prefix.  Returns the exclusive prefix.
__device__ __forceinline__ int look_back(const ScanState& st, int tile,
                                         uint32_t tag, int aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_status(st.status, tag, aggregate, true);
    return 0;
  }
  if (lane == 0) store_status(st.status + tile, tag, aggregate, false);
  int prefix = 0;
  for (int last = tile - 1;; last -= 32) {
    // lane k reads tile last - k; before tile 0 reads as a prefix of 0
    const int j = last - lane;
    int value = 0;
    bool is_prefix = true;
    if (j >= 0) {
      unsigned long long s;
      while (static_cast<uint32_t>((s = load_status(st.status + j)) >> 32) !=
             tag) {
        __nanosleep(32);
      }
      value = static_cast<int>(static_cast<uint32_t>(s) >> 1);
      is_prefix = (s & 1ull) != 0;
    }
    const uint32_t prefixes = __ballot_sync(kFullWarp, is_prefix);
    // the nearest predecessor holding a prefix ends the walk
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    prefix += __reduce_add_sync(kFullWarp, lane <= stop ? value : 0);
    if (prefixes) break;
  }
  if (lane == 0) store_status(st.status + tile, tag, prefix + aggregate, true);
  return prefix;
}

// No work beside the look-back (the row expansion's scan).
struct NoSideWork {
  __device__ void operator()(int) const {}
};

// The scan of kItems counts a thread over the launch's tiles, in the order
// (item, thread): excl[k] = the global exclusive offset of the thread's
// k-th count; *end = the tile's inclusive prefix.  While warp 0 looks
// back, warp 1 runs side(lane), after the block's first barrier.  Every
// thread calls it.
template <int kThreads, int kItems, typename Side = NoSideWork>
__device__ __forceinline__ void scan_counts(const ScanState& st, int tile,
                                            uint32_t tag,
                                            const int (&count)[kItems],
                                            int (&excl)[kItems], int* end,
                                            Side side = Side()) {
  static_assert(kThreads >= 64, "warp 1 runs the side work");
  __shared__ int s_prefix;
  int aggregate;
  block_exclusive_scan<kThreads, kItems>(count, excl, &aggregate);
  if (threadIdx.x < 32) {
    const int p = look_back(st, tile, tag, aggregate);
    if (threadIdx.x == 0) s_prefix = p;
  } else if (threadIdx.x < 64) {
    side(threadIdx.x - 32);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) excl[k] += s_prefix;
  *end = s_prefix + aggregate;
}

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The foveated re-bin: a dual-eye projection made at the display size onto
// the physical tile grid of a foveated target (the JAX package's XLA chain
// in depth_first_stereo_foveated_frame; plain version
// pipelines/depth_first.py::foveated_packed).  One thread a gaussian reads
// its four union pixel bounds and its visibility (17 B) and writes the
// physical rect word, rect_h and the re-binned visibility (9 B).  The
// arithmetic is the plain version's float32 chain, operation for operation
// and rounded as it rounds (no contraction): bound by device memory.
// ---------------------------------------------------------------------------

// The inverse warp and the grid, by value: per axis the 13 floats of
// stereo.foveated_raster_tables' inv_fit row (the degree-9 polynomial,
// highest power first, in t = (v - row[10]) / (row[11] - row[10]) * 2 - 1,
// then row[12] the fit's error margin), f32(1 / tile side) and the tiles.
struct RebinParams {
  float fit[2][13];
  float inv_tile[2];
  int tiles[2];
};

// A display coordinate through one axis' inverse warp: Horner in float32.
__device__ __forceinline__ float rebin_warp(const float (&row)[13], float v) {
  float t = __fdiv_rn(__fsub_rn(v, row[10]), __fsub_rn(row[11], row[10]));
  t = __fsub_rn(__fmul_rn(t, 2.0f), 1.0f);
  float acc = row[0];
#pragma unroll
  for (int k = 1; k < 10; ++k) acc = __fadd_rn(__fmul_rn(acc, t), row[k]);
  return acc;
}

// The physical tile of a warped coordinate, floored and clamped to the grid
// (the float-to-int conversion truncates, as PyTorch's does on the card).
__device__ __forceinline__ int rebin_tile(float v, float inv_tile, int tiles) {
  const int t = static_cast<int>(floorf(__fmul_rn(v, inv_tile)));
  return min(max(t, 0), tiles - 1);
}

__global__ void foveated_rebin_kernel(
    const float* __restrict__ px_min, const float* __restrict__ px_max,
    const float* __restrict__ py_min, const float* __restrict__ py_max,
    const bool* __restrict__ seen, int n, RebinParams p,
    int32_t* __restrict__ rect_word, int32_t* __restrict__ rect_h,
    bool* __restrict__ visible) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float mx = p.fit[0][12], my = p.fit[1][12];
  const int min_tx = rebin_tile(__fsub_rn(rebin_warp(p.fit[0], px_min[i]), mx),
                                p.inv_tile[0], p.tiles[0]);
  const int max_tx = rebin_tile(__fadd_rn(rebin_warp(p.fit[0], px_max[i]), mx),
                                p.inv_tile[0], p.tiles[0]);
  const int min_ty = rebin_tile(__fsub_rn(rebin_warp(p.fit[1], py_min[i]), my),
                                p.inv_tile[1], p.tiles[1]);
  const int max_ty = rebin_tile(__fadd_rn(rebin_warp(p.fit[1], py_max[i]), my),
                                p.inv_tile[1], p.tiles[1]);
  const bool was = seen[i];
  const bool vis = was && min_tx <= max_tx && min_ty <= max_ty;
  // a gaussian the projection sees whose re-binned rect is empty keeps its
  // visibility with an empty rect, which prep culls
  const int rect_w = was && !vis ? 0 : max_tx - min_tx + 1;
  uint32_t word = static_cast<uint32_t>(min_tx) |
                  (static_cast<uint32_t>(min_ty) << 10) |
                  (static_cast<uint32_t>(rect_w) << 20);
  if (!was) word |= GSM_CULLED_BIT;
  rect_word[i] = static_cast<int32_t>(word);
  rect_h[i] = vis ? max_ty - min_ty + 1 : 0;
  visible[i] = vis;
}

// ---------------------------------------------------------------------------
// Kernel 2: prep
// ---------------------------------------------------------------------------

// The staged record of a gaussian, one column of shared memory per thread:
// float fields, then int fields.
//   mono:   x0, y0 (window corner minus the mean), QuadRect, d2 cutoff
//   stereo: x0, y0, QuadRect of the left eye, then of the right
//   warped: mx, my, QuadRect of each eye, then the LOD ink
// ints: window width, its division magic, and (warped) the window corner.
//   none:   nothing (one unused column of each)
template <int kMode>
struct PrepRecord {
  static constexpr int kEyeFloats = 7;
  static constexpr int kFloats =
      kMode == kNone || kMode == kBand ? 1
      : kMode == kMono                 ? kEyeFloats + 1
      : kMode == kStereo               ? 2 * kEyeFloats
                                       : 2 * kEyeFloats + 1;
  static constexpr int kInts =
      kMode == kWarped ? 4 : kMode == kNone || kMode == kBand ? 1 : 2;
};

// One gaussian's terms of the header's sums (see the note at the top):
// visible, its rect's instances and its virtual rows, modulo 2^32.
struct HeaderTerms {
  uint32_t visible = 0, rect = 0, rows = 0;
};

__device__ __forceinline__ HeaderTerms header_terms(bool visible, int rect_w,
                                                    int rect_h) {
  const bool oversized =
      visible && (rect_w > GSM_MASK_W || rect_h > GSM_MASK_H);
  HeaderTerms t;
  t.visible = visible ? 1u : 0u;
  t.rect = visible ? static_cast<uint32_t>(rect_w) *
                         static_cast<uint32_t>(rect_h)
                   : 0u;
  t.rows = oversized ? static_cast<uint32_t>(rect_h) : 1u;
  return t;
}

constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kSumBlockBits = 24;  // the block count of an accumulator word

// The block's partial sums: each warp's three sums in s_part[k][warp].  The
// caller's next barrier publishes them.
__device__ __forceinline__ void warp_partials(const HeaderTerms& t,
                                              uint32_t (*s_part)[kPrepWarps]) {
  const uint32_t v = __reduce_add_sync(kFullWarp, t.visible);
  const uint32_t r = __reduce_add_sync(kFullWarp, t.rect);
  const uint32_t w = __reduce_add_sync(kFullWarp, t.rows);
  if ((threadIdx.x & 31) == 0) {
    s_part[0][threadIdx.x >> 5] = v;
    s_part[1][threadIdx.x >> 5] = r;
    s_part[2][threadIdx.x >> 5] = w;
  }
}

// Lane k < 3 of warp 1 adds the block's sum k to accumulator k; the last
// block to arrive writes the launch's total to out[k] and zeroes the word
// (see the note at the top).  Under count_rows the row demand is the scan's
// total, which the last tile writes: lane 2 stays out.
struct SumsAdder {
  const ScanState& st;
  uint32_t (*s_part)[kPrepWarps];
  int32_t* out;
  int count_rows;

  __device__ void operator()(int lane) const {
    if (lane >= 3 || (lane == 2 && count_rows)) return;
    uint32_t part = 0;
#pragma unroll
    for (int w = 0; w < kPrepWarps; ++w) part += s_part[lane][w];
    const unsigned long long old = atomicAdd(
        st.sums + lane,
        (static_cast<unsigned long long>(part) << kSumBlockBits) + 1ull);
    const unsigned long long arrived =
        old & ((1ull << kSumBlockBits) - 1ull);
    if (arrived == static_cast<unsigned long long>(st.num_tiles - 1)) {
      out[lane] = static_cast<int32_t>(
          static_cast<uint32_t>(old >> kSumBlockBits) + part);
      atomicExch(st.sums + lane, 0ull);
    }
  }
};

// The inputs and extra outputs of prep mode band (see gsm_prep_band): the
// gathered rect rows (min_ty | max_ty << 10), raw depth keys (0xFFFFFFFF
// where culled) and 8x4 masks, the band's tile rows [band0, band1), the
// KeyPlan normalization of the depth word (near_key 0 and span 0xFFFFFFFF
// leave it as it is) and the normalized depth words written.
struct BandArgs {
  const int32_t* rows;
  const int32_t* dkey;
  const int32_t* mask;
  int band0, band1;
  uint32_t near_key, span;
  int32_t* dsw_out;
};

// Gaussian i (< n) of a band frame: its band-local rect word, band
// sub-mask and normalized depth word written, its header terms in *t (of
// the rect clamped to the band), its count returned (>= 1).  The
// operations of gsm_renderer_tpu/parallel/multichip.py:245-283 and of
// binning_inputs with that mask_override, on u32 words.
__device__ __forceinline__ int prep_band(int i,
                                         const int32_t* __restrict__ rect_word,
                                         const BandArgs& b,
                                         int32_t* __restrict__ rect_out,
                                         int32_t* __restrict__ mask_out,
                                         HeaderTerms* t) {
  const uint32_t rw = static_cast<uint32_t>(rect_word[i]);
  const uint32_t rows = static_cast<uint32_t>(b.rows[i]);
  const uint32_t dk = static_cast<uint32_t>(b.dkey[i]);
  const int min_tx = rw & 0x3FFu;
  const int rect_w = (rw >> 20) & 0x3FFu;
  const int min_ty = rows & 0x3FFu;
  const int max_ty = (rows >> 10) & 0x3FFu;
  const int bty0 = max(min_ty, b.band0);
  const int bty1 = min(max_ty, b.band1 - 1);
  const int rows_in_band = max(bty1 - bty0 + 1, 0);
  const bool visible_here = dk != GSM_SENTINEL && rows_in_band > 0;
  // the global mask's rows rebased to the band clamp, cut to its rows
  const int shift = min(max(bty0 - min_ty, 0), GSM_MASK_H - 1);
  const uint32_t rows_bits =
      rows_in_band >= GSM_MASK_H
          ? 0xFFFFFFFFu
          : (1u << (8 * min(max(rows_in_band, 0), GSM_MASK_H - 1))) - 1u;
  const uint32_t sub = (static_cast<uint32_t>(b.mask[i]) >> (8 * shift)) &
                       rows_bits;
  const int sub_cnt = __popc(sub);
  const bool eligible = visible_here && rect_w <= GSM_MASK_W &&
                        max_ty - min_ty + 1 <= GSM_MASK_H;
  const bool visible = visible_here && (!eligible || sub_cnt > 0);
  const int count =
      eligible ? sub_cnt : (visible_here ? rect_w * rows_in_band : 0);
  rect_out[i] = static_cast<int32_t>(
      static_cast<uint32_t>(min_tx) |
      (static_cast<uint32_t>(bty0 - b.band0) << 10) |
      (static_cast<uint32_t>(rect_w) << 20) |
      (eligible ? GSM_MASKED_BIT : 0u) | (visible ? 0u : GSM_CULLED_BIT));
  mask_out[i] = static_cast<int32_t>(sub);
  b.dsw_out[i] = static_cast<int32_t>(min(max(dk, b.near_key) - b.near_key,
                                          b.span));
  *t = header_terms(visible_here, rect_w, rows_in_band);
  return max(count, 1);
}

__device__ __forceinline__ void stage_eye(float (*f)[kPrepThreads], int e,
                                          float ox, float oy,
                                          const QuadRect& q) {
  const int t = threadIdx.x, b = 7 * e;
  f[b + 0][t] = ox;
  f[b + 1][t] = oy;
  f[b + 2][t] = q.ca;
  f[b + 3][t] = q.cb2;
  f[b + 4][t] = q.cc;
  f[b + 5][t] = q.cb_ic;
  f[b + 6][t] = q.cb_ia;
}

__device__ __forceinline__ QuadRect staged_quad(float (*f)[kPrepThreads],
                                                int e, int s) {
  const int b = 7 * e;
  return QuadRect{f[b + 2][s], f[b + 3][s], f[b + 4][s], f[b + 5][s],
                  f[b + 6][s]};
}

// One test of the staged gaussian in slot s at window position (dx, dy):
// the expressions of the per-gaussian window loops they replace, operation
// for operation.
template <int kMode>
__device__ __forceinline__ bool prep_test(float (*f)[kPrepThreads],
                                          int (*in)[kPrepThreads], int s,
                                          int dx, int dy, const float* sb,
                                          float lod_min, int tile_w,
                                          int tile_h) {
  if constexpr (kMode == kWarped) {
    const int min_tx = in[2][s], min_ty = in[3][s];
    const float x0 = bound_at(sb, min_tx + dx);
    const float x1 = bound_at(sb, min_tx + dx + 1);
    const float y0 = bound_at(sb + kBoundsLanes, min_ty + dy);
    const float y1 = bound_at(sb + kBoundsLanes, min_ty + dy + 1);
    const float mxl = f[0][s], myl = f[1][s], mxr = f[7][s], myr = f[8][s];
    const float d2 = jmin(
        d2min_quad(staged_quad(f, 0, s), x0 - mxl, x1 - mxl, y0 - myl, y1 - myl),
        d2min_quad(staged_quad(f, 1, s), x0 - mxr, x1 - mxr, y0 - myr, y1 - myr));
    bool pass = d2 <= kStereoR2Cutoff;
    if (lod_min > 0.0f) {
      const float ar =
          (static_cast<float>(tile_w) / jmax(x1 - x0, 1e-6f)) *
          (static_cast<float>(tile_h) / jmax(y1 - y0, 1e-6f));
      pass = pass && (f[14][s] * ar >= lod_min * (1.0f - jmin(ar, 1.0f)));
    }
    return pass;
  } else {
    const float tw = static_cast<float>(tile_w);
    const float th = static_cast<float>(tile_h);
    const float ox = static_cast<float>(dx * tile_w);
    const float oy = static_cast<float>(dy * tile_h);
    const float xa = f[0][s] + ox, ya = f[1][s] + oy;
    float d2 = d2min_quad(staged_quad(f, 0, s), xa, xa + tw, ya, ya + th);
    if constexpr (kMode == kStereo) {
      const float xb = f[7][s] + ox, yb = f[8][s] + oy;
      d2 = jmin(d2, d2min_quad(staged_quad(f, 1, s), xb, xb + tw, yb,
                               yb + th));
      return d2 <= kStereoR2Cutoff;
    } else {
      return d2 <= f[7][s];
    }
  }
}

// Gaussian i (< n, else nothing, no header terms and a count of 0) of the
// thread: its mask and rect word, its window tests balanced across the
// warp, its header terms in *t; returns its count.  Every lane of the warp
// calls it.
template <int kMode>
__device__ __forceinline__ int prep_gaussian(
    int i, const int32_t* __restrict__ rect_word,
    const int32_t* __restrict__ rect_h, const WordPtrs& W, int count_rows,
    int n, int tile_w, int tile_h, float tau, float theta_unit, float inv255,
    int32_t* __restrict__ rect_out, int32_t* __restrict__ mask_out,
    float (*f)[kPrepThreads], int (*in)[kPrepThreads], const float* sb,
    float lod_min, HeaderTerms* t) {
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x & ~31;

  // 1. the gaussian, decoded once and staged
  uint32_t rw = 0;
  int rh = 0, cw = 0, tests = 0;
  if (i < n) {
    rw = static_cast<uint32_t>(rect_word[i]);
    rh = rect_h[i];
    const int min_tx = rw & 0x3FFu;
    const int min_ty = (rw >> 10) & 0x3FFu;
    cw = min(static_cast<int>((rw >> 20) & 0x3FFu), GSM_MASK_W);
    tests = cw * min(max(rh, 0), GSM_MASK_H);
    const int t = threadIdx.x;
    in[0][t] = cw;
    // dy = local * magic >> 16 is local / cw for local < 32 and cw <= 8
    in[1][t] = cw > 0 ? (65536 + cw - 1) / cw : 0;
    const Conic k0 = decode_conic(word(W, 0, i), word(W, 1, i), word(W, 2, i),
                                  theta_unit);
    if constexpr (kMode == kWarped) {
      in[2][t] = min_tx;
      in[3][t] = min_ty;
      const uint32_t l1 = word(W, 1, i), l2 = word(W, 2, i);
      const uint32_t r1 = word(W, 5, i), r2 = word(W, 6, i);
      const Conic k1 = decode_conic(word(W, 4, i), r1, r2, theta_unit);
      stage_eye(f, 0, k0.mx, k0.my, quad_rect(k0));
      stage_eye(f, 1, k1.mx, k1.my, quad_rect(k1));
      float ink = 0.0f;
      if (lod_min > 0.0f) {
        const float s1l = jmax(f16_bits_to_f32(l1 >> 16), 1e-4f);
        const float s2l = jmax(f16_bits_to_f32(l2), 1e-4f);
        const float s1r = jmax(f16_bits_to_f32(r1 >> 16), 1e-4f);
        const float s2r = jmax(f16_bits_to_f32(r2), 1e-4f);
        ink = u8f(word(W, 3, i), 24, inv255) * jmax(s1l * s2l, s1r * s2r);
      }
      f[14][t] = ink;
    } else {
      const float cx = static_cast<float>(min_tx) * static_cast<float>(tile_w);
      const float cy = static_cast<float>(min_ty) * static_cast<float>(tile_h);
      stage_eye(f, 0, cx - k0.mx, cy - k0.my, quad_rect(k0));
      if constexpr (kMode == kStereo) {
        const Conic k1 = decode_conic(word(W, 4, i), word(W, 5, i),
                                      word(W, 6, i), theta_unit);
        stage_eye(f, 1, cx - k1.mx, cy - k1.my, quad_rect(k1));
      } else {
        f[7][t] = d2_cutoff(u8f(word(W, 3, i), 24, inv255), tau);
      }
    }
  }
  __syncwarp();

  // 2. the warp's tests, 32 a round; the owner of test t is the lane whose
  // [incl - tests, incl) holds t
  const int incl = warp_inclusive_scan(tests);
  const int first = incl - tests;
  const int warp_tests = __shfl_sync(kFullWarp, incl, 31);
  uint32_t passed = 0;  // bit l: the thread's l-th test (row-major) passed
  for (int base = 0; base < warp_tests; base += 32) {
    const int t = base + lane;
    int owner = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFullWarp, incl, owner + step - 1) <= t) owner += step;
    }
    const int local = t - __shfl_sync(kFullWarp, first, owner);
    bool pass = false;
    if (t < warp_tests) {
      const int s = warp0 + owner;
      const int dy = (local * in[1][s]) >> 16;
      pass = prep_test<kMode>(f, in, s, local - dy * in[0][s], dy, sb,
                              lod_min, tile_w, tile_h);
    }
    // 3. the round's results back to their owners
    const uint32_t ballot = __ballot_sync(kFullWarp, pass);
    const int lo = max(first - base, 0), hi = min(incl - base, 32);
    if (hi > lo) {
      const int len = hi - lo;
      const uint32_t seg = (ballot >> lo) & (len == 32 ? ~0u : (1u << len) - 1u);
      passed |= seg << (base + lo - first);
    }
  }
  if (i >= n) return 0;
  uint32_t mask = 0;
#pragma unroll
  for (int dy = 0; dy < GSM_MASK_H; ++dy) {
    if (dy * cw < tests) {
      mask |= ((passed >> (dy * cw)) & ((1u << cw) - 1u)) << (dy * GSM_MASK_W);
    }
  }
  // the count: instances (the mask's popcount where the rect fits the
  // window, else the whole rect; none when culled), or virtual tile rows
  // under count_rows (rect_h for an oversized rect, else one); >= 1
  const int rect_w = (rw >> 20) & 0x3FFu;
  const int cnt = __popc(mask);
  const bool visible = (rw & GSM_CULLED_BIT) == 0;
  const bool eligible = visible && rect_w <= GSM_MASK_W && rh <= GSM_MASK_H;
  int count;
  if (count_rows) {
    count = (visible && !eligible) ? rh : 1;
  } else {
    count = visible ? (eligible ? cnt : rect_w * rh) : 0;
  }
  const bool culled = !visible || (eligible && cnt == 0);
  rect_out[i] = static_cast<int32_t>(rw | (eligible ? GSM_MASKED_BIT : 0u) |
                                     (culled ? GSM_CULLED_BIT : 0u));
  mask_out[i] = static_cast<int32_t>(mask);
  *t = header_terms(visible, rect_w, rh);
  return max(count, 1);
}

// The block of tile b preps gaussians [256 b, 256 (b + 1)), one a thread,
// and adds their header terms to the launch's sums (see the note at the
// top).
template <int kMode>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const int32_t* __restrict__ rect_word,
            const int32_t* __restrict__ rect_h, WordPtrs W, int count_rows,
            int n, int tile_w, int tile_h, float tau, float theta_unit,
            float inv255,
            int32_t* __restrict__ offsets, int32_t* __restrict__ rect_out,
            int32_t* __restrict__ mask_out, int32_t* __restrict__ sums,
            ScanState st, const float* __restrict__ bounds, float lod_min,
            BandArgs band) {
  using Rec = PrepRecord<kMode>;
  __shared__ float sb[kMode == kWarped ? 2 * kBoundsLanes : 1];
  __shared__ float f[Rec::kFloats][kPrepThreads];
  __shared__ int in[Rec::kInts][kPrepThreads];
  __shared__ uint32_t s_part[3][kPrepWarps];
  if constexpr (kMode == kWarped) stage_bounds(bounds, sb);
  uint32_t tag;
  const int tile = take_tile(st, &tag);
  const int i = tile * kPrepThreads + threadIdx.x;
  int count[1];
  HeaderTerms terms;
  if constexpr (kMode == kNone) {
    // the whole clamped rect, or one dead slot when culled
    count[0] = 0;
    if (i < n) {
      const uint32_t rw = static_cast<uint32_t>(rect_word[i]);
      const int rect_w = static_cast<int>((rw >> 20) & 0x3FFu);
      const int rh = rect_h[i];
      const bool visible = (rw & GSM_CULLED_BIT) == 0;
      count[0] = visible ? max(rect_w * rh, 1) : 1;
      terms = header_terms(visible, rect_w, rh);
    }
  } else if constexpr (kMode == kBand) {
    count[0] = i < n ? prep_band(i, rect_word, band, rect_out, mask_out,
                                 &terms)
                     : 0;
  } else {
    count[0] = prep_gaussian<kMode>(
        i, rect_word, rect_h, W, count_rows, n, tile_w, tile_h, tau,
        theta_unit, inv255, rect_out, mask_out, f, in, sb, lod_min, &terms);
  }
  warp_partials(terms, s_part);
  int excl[1], end;
  scan_counts<kPrepThreads, 1>(st, tile, tag, count, excl, &end,
                               SumsAdder{st, s_part, sums, count_rows});
  if (i < n) offsets[i] = excl[0];
  if (tile == st.num_tiles - 1 && threadIdx.x == 0) {
    offsets[n] = end;
    if (count_rows) sums[2] = end;
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: row expansion
// ---------------------------------------------------------------------------

// The block's first entry: the largest g in [0, n) with offsets[g] <= s0, for
// offsets[0] <= s0 < offsets[n].  A k-ary search: each round every thread
// probes one of kThreads evenly spaced offsets and __syncthreads_count
// counts the probes at or below s0 (a prefix, the offsets being
// non-decreasing), which narrows [lo, hi) kThreads + 1-fold: three
// rounds of one load each for a million entries.  Every thread of the block
// calls it and gets the same result.
template <int kThreads>
__device__ __forceinline__ int block_upper_bound(const int32_t* offsets, int n,
                                                 int s0) {
  int lo = 0, hi = n;  // offsets[lo] <= s0 < offsets[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + kThreads) / (kThreads + 1);
    const int p = lo + (static_cast<int>(threadIdx.x) + 1) * step;
    const int below = __syncthreads_count(p < hi && offsets[p] <= s0);
    const int lo2 = lo + below * step;
    hi = min(lo2 + step, hi);
    lo = lo2;
  }
  return lo;
}

// Widened tile-column span [t_lo, t_lo + span) of the record's ellipse
// within tile row ty (kernels/expand.py::_row_tile_span, formula for
// formula).  span 0 when the ellipse misses the row or op < tau.
__device__ __forceinline__ void row_span(uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, int ty, int min_tx,
                                         int rect_w, int tile_w, int tile_h,
                                         float tau, float theta_unit,
                                         float inv255, int* t_lo_out,
                                         int* span_out) {
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

  const float th = static_cast<float>(tile_h);
  const float y0 = static_cast<float>(ty) * th - my;
  const float y1 = y0 + th;
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
  // the float32 reciprocal of tile_w (the plain version's multiply)
  const float inv_tw = 1.0f / static_cast<float>(tile_w);
  int t_lo = static_cast<int>(floorf(xs0 * inv_tw));
  int t_hi = static_cast<int>(floorf(xs1 * inv_tw));
  t_lo = max(t_lo, min_tx);
  t_hi = min(t_hi, min_tx + rect_w - 1);
  *t_lo_out = t_lo;
  *span_out = empty ? 0 : max(t_hi - t_lo + 1, 0);
}

// A live row of the row table, tile row jj of gaussian g: its planes
// (rect', mask, dsw, w0..w3) in e, and its instance count.
__device__ __forceinline__ int expand_row(int g, int jj,
                                          const int32_t* __restrict__ rect1,
                                          const int32_t* __restrict__ mask1,
                                          const int32_t* __restrict__ dsw1,
                                          const WordPtrs& W, int tile_w,
                                          int tile_h, float tau,
                                          float theta_unit, float inv255,
                                          uint32_t (&e)[7]) {
  e[0] = static_cast<uint32_t>(rect1[g]);
  e[1] = static_cast<uint32_t>(mask1[g]);
  e[2] = static_cast<uint32_t>(dsw1[g]);
#pragma unroll
  for (int w = 0; w < 4; ++w) e[3 + w] = word(W, w, g);
  const uint32_t ru = e[0];
  if ((ru & GSM_CULLED_BIT) != 0) return 1;
  if ((ru & GSM_MASKED_BIT) != 0) return __popc(e[1]);
  // an oversized rect's row: the ellipse's column span in tile row ty
  const int min_tx = ru & 0x3FFu;
  const int ty = ((ru >> 10) & 0x3FFu) + jj;
  const int rect_w = (ru >> 20) & 0x3FFu;
  int t_lo, span;
  row_span(e[3], e[4], e[5], e[6], ty, min_tx, rect_w, tile_w, tile_h, tau,
           theta_unit, inv255, &t_lo, &span);
  e[0] = static_cast<uint32_t>(t_lo) | (static_cast<uint32_t>(ty) << 10) |
         (static_cast<uint32_t>(span) << 20);
  if (span == 0) e[0] |= GSM_CULLED_BIT;
  return span == 0 ? 1 : span;
}

// planes: (7, r_cap) = rect', mask, dsw, w0..w3 of each row.  The block of
// tile b expands rows [kRowTile b, kRowTile (b + 1)); row r0 + k * 256 +
// threadIdx.x is the thread's k-th, so that the plane writes coalesce.
__global__ void __launch_bounds__(kRowThreads)
row_expand_kernel(const int32_t* __restrict__ off1,
                  const int32_t* __restrict__ rect1,
                  const int32_t* __restrict__ mask1,
                  const int32_t* __restrict__ dsw1, WordPtrs W, int n,
                  int r_cap, int tile_w, int tile_h, float tau,
                  float theta_unit, float inv255,
                  int32_t* __restrict__ off2, int32_t* __restrict__ planes,
                  int32_t* __restrict__ row_overflow, ScanState st) {
  // the offsets of the block's gaussians g0 + k, k <= kRowTile (INT_MAX past
  // off1[n])
  __shared__ int32_t s_off[kRowTile + 1];
  uint32_t tag;
  const int tile = take_tile(st, &tag);
  const int r0 = tile * kRowTile;
  const int total1 = off1[n];
  int g0 = 0;
  if (r0 < total1) {
    g0 = block_upper_bound<kRowThreads>(off1, n, r0);
    // Row r0 + m lies in a gaussian <= g0 + m (every gaussian owns >= 1
    // row), so off1[g0 + kRowTile] > every row of the block.
    for (int k = threadIdx.x; k <= kRowTile; k += kRowThreads) {
      s_off[k] = g0 + k <= n ? off1[g0 + k] : INT_MAX;
    }
    __syncthreads();
  }
  const size_t R = static_cast<size_t>(r_cap);
  int count[kRowItems];
#pragma unroll
  for (int it = 0; it < kRowItems; ++it) {
    const int r = r0 + it * kRowThreads + threadIdx.x;
    count[it] = 0;
    if (r >= r_cap) continue;
    uint32_t e[7] = {0, 0, 0, 0, 0, 0, 0};
    if (r < total1) {
      int lo = 0;  // the largest lo with s_off[lo] <= r (< s_off[kRowTile])
#pragma unroll
      for (int half = kRowTile / 2; half >= 1; half >>= 1) {
        if (s_off[lo + half] <= r) lo += half;
      }
      count[it] = expand_row(g0 + lo, r - s_off[lo], rect1, mask1, dsw1, W,
                             tile_w, tile_h, tau, theta_unit, inv255, e);
    }
#pragma unroll
    for (int p = 0; p < 7; ++p) planes[p * R + r] = static_cast<int32_t>(e[p]);
  }
  int excl[kRowItems], end;
  scan_counts<kRowThreads, kRowItems>(st, tile, tag, count, excl, &end);
#pragma unroll
  for (int it = 0; it < kRowItems; ++it) {
    const int r = r0 + it * kRowThreads + threadIdx.x;
    if (r < r_cap) off2[r] = excl[it];
  }
  if (tile == st.num_tiles - 1 && threadIdx.x == 0) {
    off2[r_cap] = end;
    *row_overflow = total1 > r_cap ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Kernel 4: slot expansion
// ---------------------------------------------------------------------------

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

// out: (2, capacity) = key1, key2, or with plain_key (3, capacity) = the
// tile, the depth word and the entry index.  CTA b expands slots [b *
// kExpandSlots, (b + 1) * kExpandSlots); slot s0 + k * kExpandThreads +
// threadIdx.x is the thread's k-th.  row_offset: the tile row of the
// table's row 0 in the frame (a band's first row), for the mono test.
template <int kMode>
__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ rect,
              const int32_t* __restrict__ mask,
              const int32_t* __restrict__ dsw, WordPtrs W, int n,
              int capacity, int tiles_x, int tile_w, int tile_h, int d_hi,
              int d_lo, int idx_bits,
              int row_offset, int plain_key, float tau, float theta_unit,
              float inv255, int32_t* __restrict__ out,
              const float* __restrict__ bounds) {
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
    g0 = block_upper_bound<kExpandThreads>(offsets, n, s0);
    // Slot s0 + m lies in an entry <= g0 + m (g0 holds s0, and every entry
    // below the total owns >= 1 slot; a row table's dead tail, which
    // repeats the total, lies past them), so offsets[g0 + kExpandSlots] >
    // every live slot of the CTA and bounds the local search.
    for (int i = threadIdx.x; i <= kExpandSlots; i += kExpandThreads) {
      const int g = g0 + i;
      s_off[i] = g <= n ? offsets[g] : INT_MAX;
      if (g < n) {
        s_rect[i] = rect[g];
        if constexpr (kMode != kNone) s_mask[i] = mask[g];
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
    uint32_t k1 = GSM_SENTINEL, k2 = GSM_SENTINEL, entry = GSM_SENTINEL;
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
      const bool masked = kMode != kNone && (rw & GSM_MASKED_BIT) != 0;
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
      // else the unmasked ones; none in mode none
      if (!dead && kMode != kNone && (kMode == kWarped || !masked)) {
        const uint32_t a0 = word(W, 0, g), a1 = word(W, 1, g),
                       a2 = word(W, 2, g);
        bool passes;
        const float tw = static_cast<float>(tile_w);
        const float th = static_cast<float>(tile_h);
        if constexpr (kMode == kMono) {
          const float x0 = static_cast<float>(tx) * tw;
          const float y0 = static_cast<float>(ty + row_offset) * th;
          passes = rect_d2(a0, a1, a2, x0, x0 + tw, y0, y0 + th,
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
            x0 = static_cast<float>(tx) * tw;
            y0 = static_cast<float>(ty) * th;
            x1 = x0 + tw;
            y1 = y0 + th;
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
        if (plain_key) {
          k1 = tile;
          k2 = dn;
          entry = static_cast<uint32_t>(g);
        } else {
          k1 = (tile << d_hi) | (dn >> d_lo);
          const uint32_t dlo = d_lo > 0 ? (dn & ((1u << d_lo) - 1u)) : 0u;
          k2 = (idx_bits < 32 ? (dlo << idx_bits) : 0u) |
               static_cast<uint32_t>(g);
        }
      }
    }
    out[s] = static_cast<int32_t>(k1);
    out[C + s] = static_cast<int32_t>(k2);
    if (plain_key) out[2 * C + s] = static_cast<int32_t>(entry);
  }
}

}  // namespace

// Whether a launch's mode, record words, bounds table and tile go
// together: mono 4 words, none 4 words, stereo 8, warped 8 with the bounds
// table; tile sides of 1 to 4096 pixels in every mode.
static bool launch_ok(int mode, int n_words, const float* bounds, int tile_w,
                      int tile_h) {
  const int words = mode == kMono || mode == kNone ? 4 : 8;
  return mode >= kMono && mode <= kNone && n_words == words &&
         (bounds != nullptr) == (mode == kWarped) && tile_side_ok(tile_w) &&
         tile_side_ok(tile_h);
}

// The look-back scratch of a launch over `elements` elements, `per_tile` a
// block: `ticket` four words (the ticket, then prep's three accumulators of
// the header's sums), `status` at least one word a tile (see the note at
// the top; the caller allocates them zeroed once and keeps them).
static ScanState scan_state(void* ticket, void* status, int elements,
                            int per_tile) {
  ScanState st;
  st.ticket = static_cast<unsigned long long*>(ticket);
  st.sums = st.ticket + 1;
  st.status = static_cast<unsigned long long*>(status);
  st.num_tiles = elements > 0 ? (elements + per_tile - 1) / per_tile : 1;
  return st;
}

// mode: a Mode (see launch_ok); bounds: the (2, 128) table for mode
// "warped", else null.  ticket / status: the look-back scratch, ticket
// four words, status >= max(ceil(n / 256), 1) words.  tile_w, tile_h: 1 to
// 4096.  Mode none writes the offsets alone (rect_out and mask_out may be
// null).  sums: three ints, the header's visible count, visible rect total
// and row demand (see the note at the top).  One launch, even at n == 0
// (its one block writes offsets[0] = 0 and sums of 0).
extern "C" int gsm_prep(const int32_t* rect_word, const int32_t* rect_h,
                        const void* const* words, int n_words, int mode,
                        int count_rows, int n, int tile_w, int tile_h,
                        float tau,
                        float theta_unit, float inv255, int32_t* offsets,
                        int32_t* rect_out, int32_t* mask_out, int32_t* sums,
                        void* ticket, void* status, const float* bounds,
                        float lod_min, cudaStream_t stream) {
  if (!launch_ok(mode, n_words, bounds, tile_w, tile_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WordPtrs W = load_words(words, n_words);
  const ScanState st = scan_state(ticket, status, n, kPrepThreads);
  auto kernel = mode == kWarped   ? prep_kernel<kWarped>
                : mode == kStereo ? prep_kernel<kStereo>
                : mode == kNone   ? prep_kernel<kNone>
                                  : prep_kernel<kMono>;
  kernel<<<st.num_tiles, kPrepThreads, 0, stream>>>(
      rect_word, rect_h, W, count_rows, n, tile_w, tile_h, tau, theta_unit,
      inv255, offsets, rect_out, mask_out, sums, st, bounds, lod_min,
      BandArgs{});
  return static_cast<int>(cudaGetLastError());
}

// Prep mode band: the gathered planes of a band frame (rect words, rect rows
// min_ty | max_ty << 10, raw depth keys with 0xFFFFFFFF where culled, 8x4
// masks; n entries) clamped to the tile rows [band0, band1): rect_out the
// band-local rect words (min_tx | (max(min_ty, band0) - band0) << 10 |
// rect_w << 20, MASKED / CULLED), mask_out the band sub-masks, dsw_out the
// depth words normalized to [near_key, near_key + span]; offsets (n + 1) as
// gsm_prep writes them; sums the header's sums of the band clamp.  ticket /
// status as for gsm_prep.  One launch.
extern "C" int gsm_prep_band(const int32_t* rect_word, const int32_t* rows,
                             const int32_t* dkey, const int32_t* mask, int n,
                             int band0, int band1, uint32_t near_key,
                             uint32_t span, int32_t* offsets,
                             int32_t* rect_out, int32_t* mask_out,
                             int32_t* dsw_out, int32_t* sums, void* ticket,
                             void* status, cudaStream_t stream) {
  if (band0 < 0 || band1 <= band0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScanState st = scan_state(ticket, status, n, kPrepThreads);
  const BandArgs band{rows, dkey, mask, band0, band1, near_key, span, dsw_out};
  prep_kernel<kBand><<<st.num_tiles, kPrepThreads, 0, stream>>>(
      rect_word, nullptr, WordPtrs{}, 0, n, 0, 0, 0.0f, 0.0f, 0.0f, offsets,
      rect_out, mask_out, sums, st, nullptr, 0.0f, band);
  return static_cast<int>(cudaGetLastError());
}

// planes: (7, r_cap); row_overflow: one int, 1 when the row total exceeds
// r_cap; tile_w, tile_h: 1 to 4096; ticket / status as for gsm_prep,
// status >= max(ceil(r_cap / 2048), 1) words.  One launch, even at r_cap
// == 0.
extern "C" int gsm_row_expand(const int32_t* off1, const int32_t* rect1,
                              const int32_t* mask1, const int32_t* dsw1,
                              const void* const* words, int n, int r_cap,
                              int tile_w, int tile_h, float tau,
                              float theta_unit, float inv255, int32_t* off2,
                              int32_t* planes, int32_t* row_overflow,
                              void* ticket, void* status,
                              cudaStream_t stream) {
  if (!tile_side_ok(tile_w) || !tile_side_ok(tile_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WordPtrs W = load_words(words, 4);  // mono records
  const ScanState st = scan_state(ticket, status, r_cap, kRowTile);
  row_expand_kernel<<<st.num_tiles, kRowThreads, 0, stream>>>(
      off1, rect1, mask1, dsw1, W, n, r_cap, tile_w, tile_h, tau, theta_unit,
      inv255, off2, planes, row_overflow, st);
  return static_cast<int>(cudaGetLastError());
}

// out: (2, capacity) = key1, key2, or with plain_key (3, capacity) = the
// tile, the depth word and the entry index (the sentinel in all three at
// dead slots); mode: a Mode (see launch_ok); bounds: the (2, 128) table for
// mode "warped", else null; tile_w, tile_h: 1 to 4096; row_offset: mode
// mono's, else 0.  Mode none reads no mask (it may be null) and no
// word.
extern "C" int gsm_expand(const int32_t* offsets, const int32_t* rect,
                          const int32_t* mask, const int32_t* dsw,
                          const void* const* words, int n_words, int mode,
                          int n, int capacity, int tiles_x, int tile_w,
                          int tile_h, int d_hi, int d_lo, int idx_bits, int row_offset,
                          int plain_key, float tau, float theta_unit,
                          float inv255, int32_t* out, const float* bounds,
                          cudaStream_t stream) {
  if (!launch_ok(mode, n_words, bounds, tile_w, tile_h) ||
      (row_offset != 0 && mode != kMono)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WordPtrs W = load_words(words, n_words);
  if (capacity > 0) {
    const int blocks = (capacity + kExpandSlots - 1) / kExpandSlots;
    auto kernel = mode == kWarped   ? expand_kernel<kWarped>
                  : mode == kStereo ? expand_kernel<kStereo>
                  : mode == kNone   ? expand_kernel<kNone>
                                    : expand_kernel<kMono>;
    kernel<<<blocks, kExpandThreads, 0, stream>>>(
        offsets, rect, mask, dsw, W, n, capacity, tiles_x, tile_w, tile_h,
        d_hi, d_lo,
        idx_bits, row_offset, plain_key, tau, theta_unit, inv255, out,
        bounds);
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

// The foveated re-bin of n gaussians: bounds, the projection's four (n,)
// union pixel bounds; seen, its visibility; fit, the host (2, 13) inverse
// warp (copied into the launch by value); rect_word, rect_h, visible: (n,)
// outputs.  One launch, none at n == 0.
extern "C" int gsm_foveated_rebin(const float* px_min, const float* px_max,
                                  const float* py_min, const float* py_max,
                                  const bool* seen, int n, const float* fit,
                                  int tiles_x, int tiles_y, float inv_tile_w,
                                  float inv_tile_h, int32_t* rect_word,
                                  int32_t* rect_h, bool* visible,
                                  cudaStream_t stream) {
  if (tiles_x < 1 || tiles_y < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RebinParams p;
  memcpy(p.fit, fit, sizeof(p.fit));
  p.inv_tile[0] = inv_tile_w;
  p.inv_tile[1] = inv_tile_h;
  p.tiles[0] = tiles_x;
  p.tiles[1] = tiles_y;
  if (n > 0) {
    const int threads = 256;
    foveated_rebin_kernel<<<(n + threads - 1) / threads, threads, 0,
                            stream>>>(px_min, px_max, py_min, py_max, seen, n,
                                      p, rect_word, rect_h, visible);
  }
  return static_cast<int>(cudaGetLastError());
}
