// Kernel 5: front-to-back tile blend, one CTA per tile of tile_w x tile_h
// pixels (each side 1 to 4096: 16x16 in the DepthFirst, Local and Hardware
// renderers, 32x16 in the Global one; a cluster of two to four CTAs above
// 1024 pixels, and above 4096 pixels CTAs without a cluster that agree on
// the tile's exit in a scan launch before they blend), writing the color
// and depth images directly (assemble fused, ragged edge masked).
// kEyes = 2 is the single-pass dual-eye stereo blend: each entry carries
// both eyes' records (8 words: left w0..w3, right w0..w3), each pixel
// keeps one accumulator and transmittance per eye, and eye e writes
// columns [e * width, (e + 1) * width) of an (H, 2W) image.
//
// Replaces the Pallas kernel gsm_renderer_tpu/kernels/blend.py::
// _row_blend_kernel (blend_tiles_pallas, exponent_mode "vpu", depth modes
// "weighted", "none", "first_hit" and "normalized", n_eyes 1 and 2,
// r2_cutoff, pixel_coords, tile_row_offset, every tile of 1 to 4096
// pixels a side) and the XLA assemble_image after it.  Every pairing of eyes,
// cutoff, depth mode, pixel coordinates and tile takes the kernel.
//
// Records through the sorted keys: rank k of the sorted instance list is
// entry g = key2(k) & (2^idx_bits - 1) (the KeyPlan index field, the low
// bits of the int64 sort key), and its record is word row w of the entry
// table at column g (the projection's words, or a row table's).  The Pallas
// blend reads a table gathered into sorted order, a TPU habit (no cheap
// gather in the kernel); here the blend reads only the records it
// composites, and nothing gathers the table after the sort.
//
// Pixel coordinates: pixel p = ly * tile_w + lx of tile (tx, ty) sits at
// (tx * tile_w + lx, (ty + tile_row_offset) * tile_h + ly), or, with the
// foveated coordinate tables coord_x (tiles_x, P) and coord_y (tiles_y, P),
// P = tile_w * tile_h, at the display-space point (coord_x[tx][p],
// coord_y[ty][p]) it samples.  tile_row_offset is a band frame's first tile row
// (gsm_renderer_tpu/kernels/blend.py:505): the band's raster of tiles_y
// rows samples the frame's rows from there, and is written from its own row
// 0.  Writes stay clipped to width x height either way.
//
// Depth: weighted (sum of w * d); normalized (the Hardware renderer's:
// that sum over the pixel's alpha, sum(w * d) / max(1 - T, 1e-6), an IEEE
// division as in the plain version); or first_hit (the Local renderer's,
// the Pallas kernel's first_hit branch): the depth of the first record
// whose composited alpha -- after the 0.99 clamp, the same float sequence
// as the weighted blend -- exceeds 0.1, 0 for a pixel with no such record.
// A pixel keeps its hit flag and depth in registers and keeps compositing
// until the tile exits, so a hit after the pixel saturated still counts.
//
// Per record: centred linear forms u = a1 dx + b1 dy, v = a2 dx + b2 dy with
// dx = px - mx at integer pixel corners (no +0.5), alpha = min(exp(-q/2 +
// log op), 0.99), then, with a cutoff (kCutoff: the stereo blend's and the
// Hardware renderer's r^2 <= 9), alpha = 0 where q > r2_cutoff; f16 fields
// decode with subnormals flushed to zero.  The cutoff is a template
// parameter: the dual-eye blend always has one, a one-eye blend has one in
// the Hardware frame and none in the others.  The float sequence is the
// plain version's, operation for operation (--fmad=false).
//
// Batches and early exit: the tile's span [start, start + count) is walked
// in batches of 256 records aligned to 128-record blocks -- batch 0 ends at
// (start / 128 + 2) * 128, later batches are 256 long -- which are exactly
// the Pallas kernel's 2 x 128-slot chunks.  A batch is staged in rounds of
// min(threads, 256) records: each staging thread decodes one record of the
// round (per eye) into shared memory, then every thread composites the
// round's records in order; a CTA of 64 or 128 threads (8x8, 16x8, 8x16
// tiles) takes 4 or 2 rounds a batch.  The exit is tested at batch ends
// only, never between rounds, so that its granularity stays the Pallas
// chunk's whatever the tile (a band frame showed that the alignment of the
// exit changes the image).  After each batch the tile stops once every
// pixel's transmittance is below 1/255 in every eye (__syncthreads_or of
// "some pixel of the thread is not below it"; a NaN counts as not below, as
// in the plain version): the Pallas kernel's tile-level exit, which for two
// eyes waits until both saturate.  The plain version
// (kernels/blend.py) applies the same rule.
//
// Design for the H100, and what each choice does (times: chip_smoke.py and
// same-call variants on one H100 at 700 W, PERF.md):
// - Shared-memory pipe.  A record is decoded into shared memory as three
//   float4s, {mx, my, a1, b1}, {a2, b2, lop, d}, {r, g, b, 0}: reading it
//   is three broadcast LDS.128 per eye instead of eleven LDS.32.
//   An LDS.128 still returns 16 B to every lane, so the shared-memory pipe
//   moves about as many bytes as before; the loads a record takes in
//   instructions, not in bytes, are what fell.
// - Exact zeros, warp by warp (every blend with a cutoff).  A pixel's alpha is
//   exactly 0 where q > r2_cutoff.  When no pixel of a warp is within the
//   cutoff, the warp skips expf and the accumulations (w = 0 leaves the
//   sums and T bit-for-bit unchanged: T and the decoded fields are finite)
//   and never loads the third float4.  A warp covers an 8x4 block of the
//   tile, the most compact 32 pixels (8x8 at 32x32, two pixels a thread, 4
//   rows apart), so that the test fires for as many warps as it can; an
//   8-pixel-wide tile is one warp block wide.  In the general layout a
//   warp covers 32 consecutive pixels of the tile in row-major order.
//   The blends without a cutoff have no test: exact
//   zeros are rare there, the vote and branch serialised the records, and
//   without them the compiler overlaps consecutive records (the loop is
//   latency-bound).
// - One pixel a thread.  Two pixels a thread (128 threads; 1.5 LDS per
//   pixel and record) measured slower in every mode and spilled: the loop
//   is bound by latency and by the warps that can hide it, and 256 threads
//   at 40-48 registers keep 48 warps on an SM.  A 32x16 tile takes 512
//   threads for the same reason; the first 256 of them stage the batch.
//   A 32x32 tile takes 512 threads of two pixels (a CTA of 1024 would cap
//   a thread at 64 registers, and the dual-eye blend would spill).  The
//   thread count and pixels a thread are template parameters (five CTA
//   shapes, 64 to 512 threads; 30 instances, nvcc ~8 s); the tile's sides
//   are runtime arguments: they timed within the run-to-run spread of the
//   previous 16x16 and 32x16 instances (PERF.md), and instances templated
//   on the sides too (54) spilled a dual-eye 32x8 instance.
// - Other tiles (a side that is not 8, 16 or 32; and two eyes without a
//   cutoff at every tile) take the general layout (general_blend_kernel):
//   pixels in row-major order, a CTA of the fewest warps that hold the
//   tile at one pixel a thread, or two above 512 pixels (at most 512
//   threads; 24x24 is 288 threads of two pixels, 7x5 two warps), idle
//   lanes past the tile.  Above 1024 pixels (48x32 to 64x64) a tile is
//   split over a cluster of two to four CTAs of up to 1024 pixels each,
//   which share the tile's exit: each CTA votes at a batch end, writes its
//   vote to shared memory, and after a cluster barrier reads its peers'
//   through distributed shared memory, so they stop together, where the
//   plain version's tile stops.  One CTA of four pixels a thread took
//   about 80 registers (one eye) to 120 (two), a single 512-thread CTA an
//   SM; a CTA of two pixels a thread holds the state of the 32x32
//   instance (56 to 80 registers).  The general layout adds 24 instances (eyes x
//   first_hit x cutoff x {one pixel, two, two in a cluster}).
// - Tiles of more than 4096 pixels (kMaxPix: 65x65 to 4096x4096) take
//   ceil(P / 1024) CTAs of the general layout with no cluster (a portable
//   cluster holds 8 CTAs, so a cluster would stop at 8192 pixels, and
//   nothing guarantees that the CTAs of a larger tile run at once).  They
//   agree on the exit in two launches.  A CTA below the exit at a batch
//   end stays below it at every later batch end where the tile could
//   exit: transmittance never rises (it is multiplied by 1 - alpha, alpha
//   in [0, 0.99]), and a NaN (not below the exit, as in the plain version)
//   comes either from a record whose mean is not finite, which makes dx or
//   dy infinite, and so q NaN or not, at every pixel of the tile at once
//   (the idle lanes' far point included), or from a pixel coordinate that
//   is not finite, whose pixel never gets below the exit.  So the tile's
//   exit is the latest of its CTAs' own first exits.
//   (1) large_blend_kernel<..., kScan>, the exit scan: each CTA walks the
//   tile's records with the same batches and the same float sequence but
//   computes transmittance alone (no colour, no depth), stops at its first
//   batch end with every pixel below the exit, and writes the rank after
//   that batch to the tile's word by atomicMax (INT_MAX: it never got
//   there).
//   (2) large_blend_kernel<..., kSplit>: each CTA blends its pixels up to
//   that rank, with no vote.
//   Each pixel goes through the same operations as in the cluster path, so
//   the images are bit-equal to it and to the plain version.  Cost: about
//   1.5 to 2 walks of each tile's records.  The wrapper allocates the word
//   a tile; gsm_blend zeroes it on the stream.  12 more instances (the
//   scan: eyes x cutoff; the blend: eyes x first_hit x cutoff).
// - Gather latency.  The key and the words of the next batch's record are
//   loaded into registers before the current batch is composited, and the
//   key of the batch after that too, so the dependent key -> entry -> word
//   loads run behind the compositing.
// - Tile order.  Launching the heaviest tiles first (an argsort of the
//   counts) cut the foveated blend's tail but cost more than it saved in
//   mono: tiles run in index order.
//
// Bound on the H100: float operations.  A composited (pixel, record, eye)
// costs about 25 FP32 operations and one MUFU (exp), or 11 (dx, dy, u, v,
// q) where the cutoff zeroes it; the records read are 8 B of key plus 16 B
// of words per eye.
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kBatch = 256;  // records between early-exit checks
constexpr int kBlock = 128;  // batch alignment (the Pallas chunk)
// a warp covers a kWarpW x kWarpH block of the tile (sides 8, 16, 32)
constexpr int kWarpW = 8;
constexpr int kWarpH = 32 / kWarpW;
// the general layout: at most kGenThreads threads of at most two pixels a
// CTA, so a CTA holds up to kCtaPix pixels of a tile; a larger tile (up to
// kMaxPix, 64 x 64) is split over a cluster of up to kMaxCluster CTAs, and
// a tile above kMaxPix over CTAs without a cluster (the large-tile path)
constexpr int kGenThreads = 512;
constexpr int kCtaPix = 2 * kGenThreads;
constexpr int kMaxPix = 4096;
constexpr int kMaxCluster = kMaxPix / kCtaPix;
static_assert(kMaxCluster <= 8, "a portable cluster holds at most 8 CTAs");

// A side the 8x4-block instances take.
inline bool block_side(int side) {
  return side == 8 || side == 16 || side == 32;
}
// depth modes (gsm_blend's depth_mode)
enum DepthMode {
  kDepthNone = 0,
  kDepthWeighted = 1,
  kDepthFirstHit = 2,
  kDepthNormalized = 3
};
constexpr float kFirstHitAlpha = 0.1f;

// How the CTAs of a tile share it (blend_tile's kShare).
enum Share {
  kAlone = 0,    // one CTA a tile
  kCluster = 1,  // a cluster; exit votes through distributed shared memory
  kScan = 2,     // large tiles, launch 1: each CTA's own exit, no image
  kSplit = 3     // large tiles, launch 2: blend to the tile's exit
};

// The large-tile path's state (kScan, kSplit): ctas CTAs a tile;
// exit_rank[t] the rank after tile t's exit batch (the latest of its CTAs'
// own; INT_MAX: none).
struct LargeArgs {
  int ctas;
  int* exit_rank;
};

// A decoded record: {mx, my, a1, b1}, {a2, b2, lop, d}, {r, g, b, 0}.
struct Rec {
  float4 a, b, c;
};

__device__ __forceinline__ Rec decode_record(uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             float theta_unit, float inv255) {
  const float theta =
      static_cast<float>(static_cast<int>(a1 & 0xFFFFu)) * theta_unit;
  const float s1 = jmax(f16_bits_to_f32(a1 >> 16), 1e-4f);
  const float s2 = jmax(f16_bits_to_f32(a2), 1e-4f);
  const float cth = cosf(theta), sth = sinf(theta);
  const float i1 = 1.0f / s1, i2 = 1.0f / s2;
  Rec r;
  r.a = make_float4(f16_bits_to_f32(a0), f16_bits_to_f32(a0 >> 16), cth * i1,
                    sth * i1);
  r.b = make_float4(-sth * i2, cth * i2, logf(u8f(a3, 24, inv255)),
                    f16_bits_to_f32(a2 >> 16));
  r.c = make_float4(u8f(a3, 0, inv255), u8f(a3, 8, inv255),
                    u8f(a3, 16, inv255), 0.0f);
  return r;
}

// kCutoff: alpha zeroed where q > r2_cutoff, the warp test for exact zeros
// (see the head comment).  kFirstHit: first_hit depth in place of the
// weighted sum; depth_mode (a DepthMode) picks what is written.
//
// Two pixel layouts.  kThreads > 0 (blend_kernel): a tile of 8, 16 or 32
// pixels a side, kThreads threads a CTA, kPix = kThreads * kPPT pixels
// (tile_w * tile_h == kPix), 8x4 warp blocks; the first kStage threads
// stage a round of records.  kThreads == 0 (general_blend_kernel and the
// large-tile entries): any tile: blockDim.x threads (a multiple of 32, at
// most kGenThreads), pixel j of thread t is p = rank * blockDim.x * kPPT +
// j * blockDim.x + t of the tile in row-major order (ly = p / tile_w, lx =
// p % tile_w), rank the CTA's rank among those that share the tile (0
// when it is alone); lanes past the tile's P pixels are idle: they stage
// records, never write, and never hold the exit open (see kFar below).
// The largest power of two <= min(blockDim.x, kBatch) threads stage a
// round.  kShare (a Share): how the CTAs of the tile share it; the rank of
// a CTA is its rank in the cluster (kCluster) or blockIdx.x modulo la.ctas
// (kScan, kSplit).
template <int kEyes, int kThreads, int kPPT, bool kFirstHit, bool kCutoff,
          int kShare>
__device__ __forceinline__ void blend_tile(
    const uint32_t* __restrict__ key_words, uint32_t idx_mask,
    const WordPtrs& W, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, int tiles_x, int tile_w, int tile_h,
    int width, int height, int tile_row_offset, int depth_mode,
    float theta_unit, float inv255, float min_transmittance, float r2_cutoff,
    const float* __restrict__ coord_x, const float* __restrict__ coord_y,
    float* __restrict__ color, float* __restrict__ depth,
    const LargeArgs& la) {
  constexpr bool kGeneral = kThreads == 0;
  constexpr int kWords = 4 * kEyes;
  constexpr int kStageMax = kGeneral || kThreads >= kBatch ? kBatch : kThreads;
  static_assert(kGeneral || kShare == kAlone,
                "shared tiles take the general layout");
  __shared__ Rec sr[kEyes][kStageMax];

  const int t = threadIdx.x;
  const int threads = kGeneral ? static_cast<int>(blockDim.x) : kThreads;
  int stage = kStageMax;
  if constexpr (kGeneral) {
    while (stage > threads) stage >>= 1;
  }
  namespace cg = cooperative_groups;
  int tile = blockIdx.x, rank = 0, peers = 1;
  if constexpr (kShare == kCluster) {
    const cg::cluster_group cluster = cg::this_cluster();
    peers = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    tile = blockIdx.x / peers;
  } else if constexpr (kShare == kScan || kShare == kSplit) {
    tile = blockIdx.x / la.ctas;
    rank = blockIdx.x - tile * la.ctas;
  }
  // kSplit: the rank after the tile's exit batch, from the scan
  int stop = INT_MAX;
  if constexpr (kShare == kSplit) stop = la.exit_rank[tile];
  const int tx = tile % tiles_x, ty = tile / tiles_x;
  const int pix = tile_w * tile_h;
  // pixel j of the thread: its place (lx, ly) in the tile; whether it lies
  // in the tile (the general layout's lanes past the tile are idle)
  auto place = [&](int j, int* lx, int* ly) -> bool {
    if constexpr (kGeneral) {
      const int p = (rank * kPPT + j) * threads + t;
      *ly = p / tile_w;
      *lx = p - *ly * tile_w;
      return p < pix;
    } else {
      // a warp covers kWarpW x (kWarpH * kPPT) pixels: pixel j of the
      // thread sits kWarpH * j rows below its first
      const int warp = t / 32, lane = t % 32;
      const int wpr = tile_w / kWarpW;  // warps a row of warp blocks
      *lx = (warp % wpr) * kWarpW + lane % kWarpW;
      *ly = (warp / wpr) * (kWarpH * kPPT) + lane / kWarpW + kWarpH * j;
      return true;
    }
  };
  // An idle lane evaluates every record at a point kFar pixels away: its q
  // is +inf (the linear forms' coefficients are at most 1e4, the means
  // f16), so its alpha is exactly 0 and it lies outside every cutoff; its
  // transmittance starts at 0, so it never holds the tile's exit open.
  constexpr float kFar = 1e30f;
  float pxf[kPPT], pyf[kPPT], trans0[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    int lx, ly;
    const bool live = place(j, &lx, &ly);
    trans0[j] = live ? 1.0f : 0.0f;
    if (!live) {
      pxf[j] = pyf[j] = kFar;
    } else if (coord_x != nullptr) {
      const int p = ly * tile_w + lx;
      pxf[j] = coord_x[static_cast<size_t>(tx) * pix + p];
      pyf[j] = coord_y[static_cast<size_t>(ty) * pix + p];
    } else {
      pxf[j] = static_cast<float>(lx) + static_cast<float>(tx * tile_w);
      pyf[j] = static_cast<float>(ly) +
               static_cast<float>((ty + tile_row_offset) * tile_h);
    }
  }

  const int start = starts[tile];
  const int end = start + counts[tile];
  float trans[kEyes][kPPT], acc_r[kEyes][kPPT], acc_g[kEyes][kPPT],
      acc_b[kEyes][kPPT], acc_d[kEyes][kPPT];
  bool hit[kEyes][kPPT];
#pragma unroll
  for (int e = 0; e < kEyes; ++e) {
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      trans[e][j] = trans0[j];
      acc_r[e][j] = acc_g[e][j] = acc_b[e][j] = acc_d[e][j] = 0.0f;
      hit[e][j] = false;
    }
  }

  // Entry of this thread's record in the round at b0, or -1 outside the
  // span or for a thread past the round (the key's low word is key2: the
  // entry index in its low bits).
  auto entry_at = [&](int b0) -> int {
    const int s = b0 + t;
    return (t < stage && s >= start && s < end)
               ? static_cast<int>(key_words[2 * static_cast<size_t>(s)] & idx_mask)
               : -1;
  };
  uint32_t raw[kWords];
  auto fetch = [&](int g) {
    if (g >= 0) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        raw[k] = static_cast<uint32_t>(__ldg(W.w[k] + g));
      }
    }
  };

  // the cluster's exit votes, one slot a batch parity (a CTA reads its
  // peers' slot of this batch before any CTA can pass the next barrier and
  // write that slot again)
  __shared__ int vote[2];
  int parity = 0;
  int own_exit = INT_MAX;  // kScan: the rank after the CTA's own exit batch
  const int base = (start / kBlock) * kBlock;
  int g = entry_at(base);
  int g_next = entry_at(base + stage);
  fetch(g);
  for (int b0 = base; b0 < end; b0 += stage) {
    const int lo = max(b0, start) - b0, hi = min(b0 + stage, end) - b0;
    if (g >= 0) {
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        sr[e][t] = decode_record(raw[4 * e], raw[4 * e + 1], raw[4 * e + 2],
                                 raw[4 * e + 3], theta_unit, inv255);
      }
    }
    __syncthreads();
    // the next round's words (its key arrived during this one) and the key
    // of the round after it, in flight while this round is composited
    g = g_next;
    g_next = entry_at(b0 + 2 * stage);
    fetch(g);

    for (int k = lo; k < hi; ++k) {
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        const float4 A = sr[e][k].a;
        const float4 B = sr[e][k].b;
        float q[kPPT];
        bool cut[kPPT];
        bool any_in = false;
#pragma unroll
        for (int j = 0; j < kPPT; ++j) {
          const float dx = pxf[j] - A.x;
          const float dy = pyf[j] - A.y;
          const float u = A.z * dx + A.w * dy;
          const float v = B.x * dx + B.y * dy;
          q[j] = u * u + v * v;
          cut[j] = kCutoff && q[j] > r2_cutoff;
          any_in = any_in || !cut[j];
        }
        if constexpr (kCutoff) {
          if (!__any_sync(0xFFFFFFFFu, any_in)) continue;
        }
        const float4 Cc = sr[e][k].c;  // unused by the scan
#pragma unroll
        for (int j = 0; j < kPPT; ++j) {
          float alpha = jmin(expf(q[j] * -0.5f + B.z), 0.99f);
          if (cut[j]) alpha = 0.0f;
          if constexpr (kShare != kScan) {  // the scan keeps T alone
            const float w = alpha * trans[e][j];
            acc_r[e][j] = acc_r[e][j] + w * Cc.x;
            acc_g[e][j] = acc_g[e][j] + w * Cc.y;
            acc_b[e][j] = acc_b[e][j] + w * Cc.z;
            if constexpr (kFirstHit) {
              // acc_d holds the first hit's depth
              if (!hit[e][j] && alpha > kFirstHitAlpha) {
                hit[e][j] = true;
                acc_d[e][j] = B.w;
              }
            } else {
              acc_d[e][j] = acc_d[e][j] + w * B.w;
            }
          }
          trans[e][j] = trans[e][j] * (1.0f - alpha);
        }
      }
    }
    // barrier (also protects the shared round); at the end of each batch
    // of kBatch records the tile-level early exit
    if (stage < kBatch && (b0 + stage - base) % kBatch != 0) {
      __syncthreads();
      continue;
    }
    if constexpr (kShare == kSplit) {
      // no vote: the scan found the tile's exit batch
      if (b0 + stage >= stop) break;
      __syncthreads();
      continue;
    }
    bool open = false;  // a pixel of the thread not below the exit
#pragma unroll
    for (int e = 0; e < kEyes; ++e) {
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        open = open || !(trans[e][j] < min_transmittance);
      }
    }
    int any_open = __syncthreads_or(open);
    if constexpr (kShare == kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      if (t == 0) vote[parity] = any_open;
      cluster.sync();
      for (int r = 0; r < peers; ++r) {
        any_open |= *cluster.map_shared_rank(&vote[parity], r);
      }
      parity ^= 1;
    }
    if (!any_open) {
      if constexpr (kShare == kScan) own_exit = b0 + stage;
      break;
    }
  }
  if constexpr (kShare == kCluster) {
    // no CTA leaves while a peer may still read its votes
    cg::this_cluster().sync();
  }
  if constexpr (kShare == kScan) {
    if (t == 0) atomicMax(la.exit_rank + tile, own_exit);
    return;
  }

#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    int lx, ly;
    const bool live = place(j, &lx, &ly);
    const int x = tx * tile_w + lx, y = ty * tile_h + ly;
    if (live && x < width && y < height) {
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        const size_t p =
            static_cast<size_t>(y) * (kEyes * width) + e * width + x;
        float4 c;
        c.x = acc_r[e][j];
        c.y = acc_g[e][j];
        c.z = acc_b[e][j];
        c.w = 1.0f - trans[e][j];
        reinterpret_cast<float4*>(color)[p] = c;
        if (depth_mode == kDepthNormalized) {
          depth[p] = acc_d[e][j] / jmax(c.w, 1e-6f);
        } else if (depth_mode != kDepthNone) {
          depth[p] = acc_d[e][j];
        }
      }
    }
  }
}

// The 8x4-block entry: the bound of its own CTA, 256 for the smaller ones
// (under their own, ptxas capped the 128-thread first_hit instances at 56
// registers and spilled).
template <int kEyes, int kThreads, int kPPT, bool kFirstHit, bool kCutoff>
__global__ void __launch_bounds__(kThreads < kBatch ? kBatch : kThreads)
blend_kernel(const uint32_t* __restrict__ key_words, uint32_t idx_mask,
             WordPtrs W, const int32_t* __restrict__ starts,
             const int32_t* __restrict__ counts, int tiles_x, int tile_w,
             int tile_h, int width, int height, int tile_row_offset,
             int depth_mode, float theta_unit, float inv255,
             float min_transmittance, float r2_cutoff,
             const float* __restrict__ coord_x,
             const float* __restrict__ coord_y,
             float* __restrict__ color, float* __restrict__ depth) {
  blend_tile<kEyes, kThreads, kPPT, kFirstHit, kCutoff, kAlone>(
      key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h, width,
      height, tile_row_offset, depth_mode, theta_unit, inv255,
      min_transmittance, r2_cutoff, coord_x, coord_y, color, depth,
      LargeArgs{});
}

// The general-layout entry.  It declares one CTA an SM as its minimum:
// with the 512-thread bound alone ptxas held some two-pixel instances to
// 64 registers and spilled.
template <int kEyes, int kPPT, bool kFirstHit, bool kCutoff, bool kClustered>
__global__ void __launch_bounds__(kGenThreads, 1)
general_blend_kernel(const uint32_t* __restrict__ key_words,
                     uint32_t idx_mask, WordPtrs W,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ counts, int tiles_x,
                     int tile_w, int tile_h, int width, int height,
                     int tile_row_offset, int depth_mode, float theta_unit,
                     float inv255, float min_transmittance, float r2_cutoff,
                     const float* __restrict__ coord_x,
                     const float* __restrict__ coord_y,
                     float* __restrict__ color, float* __restrict__ depth) {
  blend_tile<kEyes, 0, kPPT, kFirstHit, kCutoff,
             kClustered ? kCluster : kAlone>(
      key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h, width,
      height, tile_row_offset, depth_mode, theta_unit, inv255,
      min_transmittance, r2_cutoff, coord_x, coord_y, color, depth,
      LargeArgs{});
}

// The large-tile entries (tiles of more than kMaxPix pixels, la.ctas CTAs
// of two pixels a thread each, no cluster; see the head comment):
// kScan writes each tile's exit rank, kSplit blends to it.  The scan's
// transmittance does not depend on the depth mode: one instance serves
// first_hit and the rest.
template <int kEyes, bool kFirstHit, bool kCutoff, int kShare>
__global__ void __launch_bounds__(kGenThreads, 1)
large_blend_kernel(const uint32_t* __restrict__ key_words, uint32_t idx_mask,
                   WordPtrs W, const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ counts, int tiles_x,
                   int tile_w, int tile_h, int width, int height,
                   int tile_row_offset, int depth_mode, float theta_unit,
                   float inv255, float min_transmittance, float r2_cutoff,
                   const float* __restrict__ coord_x,
                   const float* __restrict__ coord_y,
                   float* __restrict__ color, float* __restrict__ depth,
                   LargeArgs la) {
  blend_tile<kEyes, 0, 2, kFirstHit, kCutoff, kShare>(
      key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h, width,
      height, tile_row_offset, depth_mode, theta_unit, inv255,
      min_transmittance, r2_cutoff, coord_x, coord_y, color, depth, la);
}

using BlendFn = decltype(&blend_kernel<1, 256, 1, false, false>);
using LargeFn = decltype(&large_blend_kernel<1, false, false, kScan>);

// A launch: the kernel, its CTA size and the CTAs a tile.
struct BlendLaunch {
  BlendFn kernel;
  int threads, cluster;
};

// The 8x4-block instance for a tile of kPix pixels: a thread a pixel up to
// 512 pixels (64 to 512 threads), and 512 threads of two pixels each at
// 32x32 (1024 threads a CTA would leave a thread 64 registers).
template <int kEyes, int kPix, bool kFirstHit, bool kCutoff>
BlendLaunch blend_for() {
  constexpr int kPPT = kPix > 512 ? kPix / 512 : 1;
  return {blend_kernel<kEyes, kPix / kPPT, kPPT, kFirstHit, kCutoff>,
          kPix / kPPT, 1};
}

template <int kEyes, bool kFirstHit, bool kCutoff>
BlendLaunch pick_pixels(int pix) {
  switch (pix) {
    case 64: return blend_for<kEyes, 64, kFirstHit, kCutoff>();
    case 128: return blend_for<kEyes, 128, kFirstHit, kCutoff>();
    case 256: return blend_for<kEyes, 256, kFirstHit, kCutoff>();
    case 512: return blend_for<kEyes, 512, kFirstHit, kCutoff>();
    default: return blend_for<kEyes, 1024, kFirstHit, kCutoff>();
  }
}

// The general layout's CTAs for a tile of pix pixels: the fewest CTAs of
// at most kCtaPix pixels each, each taking one pixel a thread up to
// kGenThreads pixels and two above, in the fewest warps that hold its
// share.
struct GeneralShape {
  int ctas, ppt, threads;
};

GeneralShape general_shape(int pix) {
  const int ctas = (pix + kCtaPix - 1) / kCtaPix;
  const int share = (pix + ctas - 1) / ctas;
  const int ppt = share <= kGenThreads ? 1 : 2;
  return {ctas, ppt, ((share + ppt - 1) / ppt + 31) / 32 * 32};
}

// The general-layout launch for a tile of pix pixels (<= kMaxPix): a
// cluster when it takes more than one CTA.
template <int kEyes, bool kFirstHit, bool kCutoff>
BlendLaunch pick_general(int pix) {
  const GeneralShape S = general_shape(pix);
  const BlendFn kernel =
      S.ctas > 1   ? general_blend_kernel<kEyes, 2, kFirstHit, kCutoff, true>
      : S.ppt == 2 ? general_blend_kernel<kEyes, 2, kFirstHit, kCutoff, false>
                   : general_blend_kernel<kEyes, 1, kFirstHit, kCutoff, false>;
  return {kernel, S.threads, S.ctas};
}

// The 8x4-block instances at sides of 8, 16 and 32 pixels (blocks), but
// for two eyes without a cutoff; the general layout otherwise.
template <int kEyes, bool kFirstHit, bool kCutoff>
BlendLaunch pick_layout(bool blocks, int pix) {
  if constexpr (kEyes == 2 && !kCutoff) {
    return pick_general<kEyes, kFirstHit, kCutoff>(pix);
  } else {
    return blocks ? pick_pixels<kEyes, kFirstHit, kCutoff>(pix)
                  : pick_general<kEyes, kFirstHit, kCutoff>(pix);
  }
}

// The launch of a tile (see pick_layout).
BlendLaunch pick_blend(bool two, bool first_hit, bool cutoff, int tile_w,
                       int tile_h) {
  const int pix = tile_w * tile_h;
  const bool blocks = block_side(tile_w) && block_side(tile_h);
  if (two) {
    if (cutoff) {
      return first_hit ? pick_layout<2, true, true>(blocks, pix)
                       : pick_layout<2, false, true>(blocks, pix);
    }
    return first_hit ? pick_layout<2, true, false>(blocks, pix)
                     : pick_layout<2, false, false>(blocks, pix);
  }
  if (cutoff) {
    return first_hit ? pick_layout<1, true, true>(blocks, pix)
                     : pick_layout<1, false, true>(blocks, pix);
  }
  return first_hit ? pick_layout<1, true, false>(blocks, pix)
                   : pick_layout<1, false, false>(blocks, pix);
}

// The large-tile path's two kernels: the exit scan and the blend.
struct LargeLaunch {
  LargeFn scan, blend;
};

template <int kEyes, bool kFirstHit, bool kCutoff>
LargeLaunch large_for() {
  return {large_blend_kernel<kEyes, false, kCutoff, kScan>,
          large_blend_kernel<kEyes, kFirstHit, kCutoff, kSplit>};
}

LargeLaunch pick_large(bool two, bool first_hit, bool cutoff) {
  if (two) {
    if (cutoff) {
      return first_hit ? large_for<2, true, true>()
                       : large_for<2, false, true>();
    }
    return first_hit ? large_for<2, true, false>()
                     : large_for<2, false, false>();
  }
  if (cutoff) {
    return first_hit ? large_for<1, true, true>()
                     : large_for<1, false, true>();
  }
  return first_hit ? large_for<1, true, false>()
                   : large_for<1, false, false>();
}

}  // namespace

// sorted_key: (capacity,) int64 sort keys (key2 in the low 32 bits, the
// entry index in its low idx_bits); words: 4 * n_eyes pointers to the (N,)
// int32 word rows of the entry table; tile_w, tile_h: 1 to 4096 pixels
// (tile_side_ok); depth_mode: a DepthMode; coord_x (tiles_x, tile_w *
// tile_h) and coord_y (tiles_y, tile_w * tile_h) the foveated pixel
// coordinates, or both null; tile_row_offset >= 0 (0 with coordinate
// tables); color (H, n_eyes * W, 4), depth (H, n_eyes * W) unless
// depth_mode is none.  r2_cutoff >= 0 (0: no cutoff).  large: tiles_x *
// tiles_y int32 of scratch for a tile of more than kMaxPix pixels (any
// contents: zeroed here on the stream), else unused (may be null).  Every
// pairing of eyes, cutoff, depth mode and pixel coordinates takes every
// tile.  One launch, a cluster launch above 1024 pixels, or a memset and
// two launches above kMaxPix pixels.
extern "C" int gsm_blend(const int64_t* sorted_key, int idx_bits,
                         const void* const* words, int n_words,
                         const int32_t* starts, const int32_t* counts,
                         int tiles_x, int tiles_y, int width, int height,
                         int tile_row_offset, int tile_w, int tile_h,
                         int depth_mode, float theta_unit, float inv255,
                         float min_transmittance, float r2_cutoff,
                         const float* coord_x,
                         const float* coord_y, float* color, float* depth,
                         int32_t* large, cudaStream_t stream) {
  const bool two = n_words == 8;
  const bool cutoff = r2_cutoff > 0.0f;
  if ((n_words != 4 && !two) || idx_bits < 1 || idx_bits > 32 ||
      !(r2_cutoff >= 0.0f) || !tile_side_ok(tile_w) ||
      !tile_side_ok(tile_h) || depth_mode < kDepthNone ||
      depth_mode > kDepthNormalized || tile_row_offset < 0 ||
      (tile_row_offset != 0 && coord_x != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WordPtrs W = load_words(words, n_words);
  const uint32_t idx_mask =
      idx_bits == 32 ? 0xFFFFFFFFu : ((1u << idx_bits) - 1u);
  const uint32_t* key_words = reinterpret_cast<const uint32_t*>(sorted_key);
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const bool first_hit = depth_mode == kDepthFirstHit;
  const int pix = tile_w * tile_h;
  if (pix > kMaxPix) {
    const GeneralShape S = general_shape(pix);
    const long long grid = static_cast<long long>(n_tiles) * S.ctas;
    if (large == nullptr || grid > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaMemsetAsync(
        large, 0, static_cast<size_t>(n_tiles) * sizeof(int32_t), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    // S.ppt is 2 above kMaxPix pixels: the instances' two pixels a thread
    const LargeLaunch L = pick_large(two, first_hit, cutoff);
    const LargeArgs la{S.ctas, large};
    const LargeFn kernels[2] = {L.scan, L.blend};
    for (const LargeFn kernel : kernels) {
      kernel<<<static_cast<unsigned>(grid), S.threads, 0, stream>>>(
          key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h,
          width, height, tile_row_offset, depth_mode, theta_unit, inv255,
          min_transmittance, r2_cutoff, coord_x, coord_y, color, depth, la);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
  }
  const BlendLaunch L = pick_blend(two, first_hit, cutoff, tile_w, tile_h);
  if (L.cluster == 1) {
    L.kernel<<<n_tiles, L.threads, 0, stream>>>(
        key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h,
        width, height, tile_row_offset, depth_mode, theta_unit, inv255,
        min_transmittance, r2_cutoff, coord_x, coord_y, color, depth);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_tiles) * L.cluster);
  config.blockDim = dim3(L.threads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, L.kernel, key_words, idx_mask, W, starts, counts, tiles_x,
      tile_w, tile_h, width, height, tile_row_offset, depth_mode, theta_unit,
      inv255, min_transmittance, r2_cutoff, coord_x, coord_y, color, depth);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
