// Kernel 5: front-to-back tile blend of tile_w x tile_h pixels (each side
// 1 to 4096: 16x16 in the DepthFirst, Local and Hardware renderers, 32x16
// in the Global one), writing the color and depth images directly
// (assemble fused, ragged edge masked): one CTA a tile at sides of 8, 16
// and 32 pixels (8x4 warp blocks), other tiles in the split layout (one
// CTA, or a cluster of up to eight, up to 4096 pixels; above 4096 pixels
// CTAs without a cluster that blend to their own exits and then resume to
// the tile's).
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
//   8-pixel-wide tile is one warp block wide (the split layout's blocks:
//   below).  The blends without a cutoff have no such test: exact zeros
//   are rare on small tiles, the vote and branch serialised the records,
//   and without them the compiler overlaps consecutive records (the loop
//   is latency-bound); on larger tiles the split layout culls them by
//   warp box (below).
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
//   cutoff at every tile) take the split layout (general_blend_kernel,
//   resume_blend_kernel; split_tile): one pixel a thread, warps over
//   compact warp blocks of the tile padded to whole blocks (on a tile of
//   up to 4096 pixels the most compact block, 8x4 first, that takes no
//   more warps than row-major strips, else strips: 12x12 and 20x12 in
//   strips took 0.248 -> 0.224 and 0.327 -> 0.257 ms against 8x4 blocks
//   with a fifth and an eighth more warps; on a larger tile up to 5/4 as
//   many: 65x65 in 8x4 blocks 3.0 ms, in strips 3.5), idle lanes at the
//   ragged edge (see kFar), the blocks spread evenly over the fewest CTAs
//   of at most 16 warps (split_layout; gsm_blend_layout reports it to the
//   wrapper, which sizes the large-tile scratch by it).  Up
//   to 4096 pixels the CTAs of a tile form one cluster (two to eight
//   CTAs: 24x24 two of nine warps, 64x64 eight of sixteen) and share the
//   tile's exit: each CTA votes at a batch end, writes its vote to shared
//   memory, and after a cluster barrier reads its peers' through
//   distributed shared memory, so they stop together, where the plain
//   version's tile stops.  Against the earlier general layout (row-major
//   pixels, two a thread above 512, 74-80 registers and 18 warps an SM
//   for two eyes) the blocks and one pixel a thread (64 registers, 27-32
//   warps) took 24x24 mono 0.57 -> 0.47 ms, two eyes with the cutoff 1.49
//   -> 1.17, without it 1.94 -> 1.66, 64x64 3.98 -> 2.90 (same call,
//   PERF.md).  64 registers is the launch bound's cap: two CTAs of 512
//   threads an SM.  The staged round lives in dynamic shared memory sized
//   by it (kEyes * stage records: 3 KB at 64 threads, not 12): 7x5 went
//   0.313 -> 0.254 ms, 48x16 0.594 -> 0.580 (same call).
// - Record culling by warp (kCull: every blend with a cutoff, and without
//   one above 1024 pixels).  A staging thread tests its record against
//   each warp's box of live pixels (computed once) and writes the warps it
//   can reach; after the round's barrier each warp lists, by ballot, the
//   records that reach it, eye by eye, and composites those alone, so a
//   record that cannot reach a warp costs it nothing (see reach_mask for
//   why the skip is exact; the cutoff's warp test still runs inside).
//   Against the cutoff's warp test alone (same call, PERF.md): the
//   two-eye 24x24 blend with the cutoff 0.98 -> 0.66 ms, Hardware 24x24
//   0.375 -> 0.268; large tiles 128x128 9.3 -> 5.4, stereo 96x96 5.9 ->
//   2.2, Hardware 128x128 5.5 -> 1.7, foveated 128x128 7.9 -> 2.9.  A
//   per-record warp mask read in the loop (the first form) saved less:
//   it cost the near records a load and a branch each.  Without a cutoff
//   the zero reach (expf of the exponent below kExpZero, about 15 sigma)
//   covers a small tile whole, hence the 1024-pixel floor there.
// - Tiles of more than 4096 pixels (kMaxPix: 65x65 to 4096x4096) take
//   CTAs of at most 8 warps with no cluster (a portable cluster holds 8
//   CTAs, and nothing guarantees that the CTAs of a larger tile run at
//   once).  A CTA below the exit at a batch end stays below it at every
//   later batch end where the tile could exit: transmittance never rises
//   (it is multiplied by 1 - alpha, alpha in [0, 0.99]), and a NaN (not
//   below the exit, as in the plain version) comes only from a pixel
//   coordinate that is not finite (the decoded fields are finite: see
//   kReachMargin), whose pixel never gets below the exit.  So the tile's
//   exit is the latest of its CTAs' own first exits, and one walk serves:
//   (1) general_blend_kernel on the large tile: each CTA blends its pixels
//   to its own first exit, writes its image as if the tile ended there,
//   records that exit (INT_MAX: none) and raises the tile's to it by
//   atomicMax; where it stopped early it also saves each pixel's
//   transmittance (first-hit flag in its sign bit) and depth sum (8 B a
//   pixel an eye; the colour sums stay in the image).
//   (2) resume_blend_kernel: a CTA whose own exit came before its tile's
//   reloads that state and blends on from its own exit, a batch end and
//   so a round boundary, to the tile's exit with no vote; the others
//   return at once.  Each pixel goes through the same operations as in the
//   cluster path, so the images are bit-equal to it and to the plain
//   version.  The earlier exit scan (transmittance alone) before a second,
//   full walk took 40-53% of these blends; the resume took 128x128 mono
//   27.4 -> 15.1 ms and stereo 96x96 17.9 -> 11.8 before culling (same
//   call, PERF.md).  The wrapper allocates the scratch (exits: a word a
//   tile and one a CTA; state: 8 B a pixel an eye); gsm_blend zeroes the
//   tiles' words on the stream.  24 split instances (eyes x first_hit x
//   cutoff x {walk, walk with culling, resume}).
// - Gather latency.  The key and the words of the next batch's record are
//   loaded into registers before the current batch is composited, and the
//   key of the batch after that too, so the dependent key -> entry -> word
//   loads run behind the compositing.
// - Tile order.  Launching the heaviest tiles first (an argsort of the
//   counts) cut the foveated blend's tail but cost more than it saved in
//   mono at 16x16: there tiles run in index order.  On the large-tile
//   path the wrapper passes that order (Split::order) and the CTAs of the
//   tiles with the most records start first: stereo 96x96 7.2 -> 5.9 ms,
//   without a cutoff 14.4 -> 12.1, 65x65 4.3 -> 4.1, foveated 128x128 7.8
//   -> 7.9 (same call, before the warps' lists, PERF.md).
//
// Bound on the H100: float operations.  A composited (pixel, record, eye)
// costs about 25 FP32 operations and one MUFU (exp), or 11 (dx, dy, u, v,
// q) where the cutoff zeroes it; the records read are 8 B of key plus 16 B
// of words per eye.  Where records are culled (kCull) the work that cannot
// be skipped is less: a box test a (warp, record, eye) and only the pairs
// within the record's reach (chip_smoke.py, blend_reach_flops).
#include <climits>
#include <cstring>
#include <vector>
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kBatch = 256;  // records between early-exit checks
constexpr int kBlock = 128;  // batch alignment (the Pallas chunk)
// a warp covers a kWarpW x kWarpH block of the tile (sides 8, 16, 32)
constexpr int kWarpW = 8;
constexpr int kWarpH = 32 / kWarpW;
// the split layout (general_blend_kernel, resume_blend_kernel): CTAs of at
// most kSplitWarps warps of one pixel a thread; a tile of up to kMaxPix
// pixels takes one CTA or a cluster of up to kMaxCluster, a larger tile
// CTAs without a cluster (the large-tile path)
constexpr int kSplitWarps = 16;
constexpr int kLargeWarps = 8;
constexpr int kMaxPix = 4096;
constexpr int kMaxCluster = 8;
// the split layout culls records by warp (kCull, split_tile) with a
// cutoff, and without one on tiles of more pixels than this
constexpr int kCullPix = 1024;
static_assert(kMaxCluster <= 8, "a portable cluster holds at most 8 CTAs");
// a tile of up to kMaxPix pixels takes at most kMaxPix / 32 warps (blocks
// only where they take no more than strips), so at most kMaxCluster CTAs
static_assert(kMaxPix / 32 <= kSplitWarps * kMaxCluster,
              "a cluster must hold every tile of up to kMaxPix pixels");
// warp block widths, the most compact first (a warp covers w x 32 / w
// pixels; split_layout)
constexpr int kWarpWidths[] = {8, 4, 16, 2, 32, 1};

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

// The 8x4-block body (blend_kernel): a tile of 8, 16 or 32 pixels a side,
// kThreads threads a CTA, kPix = kThreads * kPPT pixels (tile_w * tile_h ==
// kPix), 8x4 warp blocks; the first kStage threads stage a round of
// records.  kCutoff: alpha zeroed where q > r2_cutoff, the warp test for
// exact zeros (see the head comment).  kFirstHit: first_hit depth in place
// of the weighted sum; depth_mode (a DepthMode) picks what is written.
template <int kEyes, int kThreads, int kPPT, bool kFirstHit, bool kCutoff>
__device__ __forceinline__ void blend_tile(
    const uint32_t* __restrict__ key_words, uint32_t idx_mask,
    const WordPtrs& W, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, int tiles_x, int tile_w, int tile_h,
    int width, int height, int tile_row_offset, int depth_mode,
    float theta_unit, float inv255, float min_transmittance, float r2_cutoff,
    const float* __restrict__ coord_x, const float* __restrict__ coord_y,
    float* __restrict__ color, float* __restrict__ depth) {
  constexpr int kWords = 4 * kEyes;
  constexpr int kStageMax = kThreads >= kBatch ? kBatch : kThreads;
  __shared__ Rec sr[kEyes][kStageMax];

  const int t = threadIdx.x;
  const int stage = kStageMax;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x, ty = tile / tiles_x;
  const int pix = tile_w * tile_h;
  // pixel j of the thread: its place (lx, ly) in the tile; a warp covers
  // kWarpW x (kWarpH * kPPT) pixels: pixel j of the thread sits kWarpH * j
  // rows below its first
  auto place = [&](int j, int* lx, int* ly) {
    const int warp = t / 32, lane = t % 32;
    const int wpr = tile_w / kWarpW;  // warps a row of warp blocks
    *lx = (warp % wpr) * kWarpW + lane % kWarpW;
    *ly = (warp / wpr) * (kWarpH * kPPT) + lane / kWarpW + kWarpH * j;
  };
  float pxf[kPPT], pyf[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    int lx, ly;
    place(j, &lx, &ly);
    if (coord_x != nullptr) {
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
      trans[e][j] = 1.0f;
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
        const float4 Cc = sr[e][k].c;
#pragma unroll
        for (int j = 0; j < kPPT; ++j) {
          float alpha = jmin(expf(q[j] * -0.5f + B.z), 0.99f);
          if (cut[j]) alpha = 0.0f;
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
    bool open = false;  // a pixel of the thread not below the exit
#pragma unroll
    for (int e = 0; e < kEyes; ++e) {
#pragma unroll
      for (int j = 0; j < kPPT; ++j) {
        open = open || !(trans[e][j] < min_transmittance);
      }
    }
    if (!__syncthreads_or(open)) break;
  }

#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    int lx, ly;
    place(j, &lx, &ly);
    const int x = tx * tile_w + lx, y = ty * tile_h + ly;
    if (x < width && y < height) {
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

// The split layout of a tile (general_blend_kernel, resume_blend_kernel):
// warp_w > 0: warp blocks of warp_w x (32 / warp_w) pixels (warp_w a power
// of two), in row-major order over the tile padded to whole blocks; warp_w
// 0: strips of 32 consecutive pixels in row-major order.  ctas CTAs share
// the tile, each of blockDim.x / 32 warps: warp w of CTA rank covers block
// (or strip) rank * blockDim.x / 32 + w.  Large tiles (more than kMaxPix
// pixels): exits holds each tile's exit rank (zeroed by gsm_blend, then
// the latest of its CTAs' own) followed by each CTA's own exit rank,
// state the (height, eyes * width) pixels' {transmittance bits | first hit
// << 31, depth sum or first-hit depth} where a CTA stopped before the
// tile, order the tiles by record count, the most first (the launch
// order); all null otherwise.
struct Split {
  int warp_w, ctas;
  int* exits;
  uint2* state;
  const int32_t* order;  // large tiles: the tiles in launch order
};

// kCull: a record changes a pixel only where its alpha is not exactly 0,
// which needs q <= r2, r2 = r2_cutoff with a cutoff, else 2 * (lop -
// kExpZero) (below kExpZero expf is exactly 0: gsm_expf_zero_check holds
// every float below it to that on the card).  The linear forms' rows are
// (cos, sin) / s1 and (-sin, cos) / s2, so q >= |d|^2 / max(s1, s2)^2 for
// an offset d from the mean; with the forms' rounding (at most 2% of q at
// any anisotropy the f16 scales allow) a pixel farther than
// sqrt(kReachMargin * r2) * max(s1, s2) from the mean has q > r2.  A warp
// whose pixels all lie that far skips the record: exact, as the cutoff's
// warp test is.  It needs q to be a number: the decoded fields always are
// (f16_bits_to_f32 reads exponent 31, an f16 overflow or NaN, as 2^16 (1 +
// m / 1024), as the reference's decode does), and a pixel coordinate is
// unless the caller's coordinate tables hold inf or NaN; there q may be
// NaN, which the plain version composites, so a CTA with such a pixel
// gives every warp the whole plane as its box and culls nothing.
constexpr float kExpZero = -110.0f;
constexpr float kReachMargin = 1.1f;

// The warps of a CTA a decoded record r (its words w1, w2: the scales)
// can reach: bit w set unless every pixel of warp w's box {x0, y0, x1, y1}
// lies beyond the record's reach (see kReachMargin) for its q limit r2.
__device__ __forceinline__ uint32_t reach_mask(const Rec& r, uint32_t w1,
                                               uint32_t w2, float r2,
                                               const float4* box,
                                               int warps) {
  const float s = fmaxf(jmax(f16_bits_to_f32(w1 >> 16), 1e-4f),
                        jmax(f16_bits_to_f32(w2), 1e-4f));
  const float lim = kReachMargin * r2 * s * s;
  uint32_t bits = 0;
  for (int w = 0; w < warps; ++w) {
    const float4 b = box[w];
    const float dx = fmaxf(fmaxf(b.x - r.a.x, r.a.x - b.z), 0.0f);
    const float dy = fmaxf(fmaxf(b.y - r.a.y, r.a.y - b.w), 0.0f);
    if (!(dx * dx + dy * dy > lim)) bits |= 1u << w;
  }
  return bits;
}

// Warp blocks (or strips) of a tile of tile_w x tile_h pixels.
inline int split_blocks(int tile_w, int tile_h, int warp_w) {
  if (warp_w == 0) return (tile_w * tile_h + 31) / 32;
  const int bh = 32 / warp_w;
  return ((tile_w + warp_w - 1) / warp_w) * ((tile_h + bh - 1) / bh);
}

// The split layout of a tile (see Split): warps over the most compact warp
// blocks that take no more warps than row-major strips (on a tile of more
// than kMaxPix pixels at most 5/4 as many), else strips; one pixel a
// thread; the fewest CTAs of at most kSplitWarps warps (kLargeWarps above
// kMaxPix pixels), the blocks spread evenly over them.
struct Layout {
  int warp_w, cta_warps, ctas;
};

Layout split_layout(int tile_w, int tile_h) {
  const bool large = tile_w * tile_h > kMaxPix;
  const int strips = split_blocks(tile_w, tile_h, 0);
  int warp_w = 0, blocks = strips;
  for (const int w : kWarpWidths) {
    const int n = split_blocks(tile_w, tile_h, w);
    if (large ? 4 * n <= 5 * strips : n <= strips) {
      warp_w = w;
      blocks = n;
      break;
    }
  }
  const int most = large ? kLargeWarps : kSplitWarps;
  const int ctas = (blocks + most - 1) / most;
  return {warp_w, (blocks + ctas - 1) / ctas, ctas};
}

// The split-layout body, one pixel a thread.  kResume false: the walk from
// the span's start, alone (ctas 1), in a cluster of ctas CTAs that vote on
// the exit together (tiles of up to kMaxPix pixels), or, on a large tile
// (sp.exits not null), to the CTA's own first exit, after which it
// records that exit and, if it stopped early, its pixels' state.  kResume
// true (large tiles, the second launch): a CTA whose own exit came before
// its tile's picks up its pixels' state there and blends on, with no vote,
// to the tile's exit.  kCutoff, kFirstHit, depth_mode as in blend_tile.
template <int kEyes, bool kFirstHit, bool kCutoff, bool kResume, bool kCull>
__device__ __forceinline__ void split_tile(
    const uint32_t* __restrict__ key_words, uint32_t idx_mask,
    const WordPtrs& W, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ counts, int tiles_x, int tile_w, int tile_h,
    int width, int height, int tile_row_offset, int depth_mode,
    float theta_unit, float inv255, float min_transmittance, float r2_cutoff,
    const float* __restrict__ coord_x, const float* __restrict__ coord_y,
    float* __restrict__ color, float* __restrict__ depth, const Split& sp) {
  constexpr int kWords = 4 * kEyes;
  // records of a warp's list composited an iteration: four where one eye
  // has no first hit to keep (ptxas's own choice), else two (four spilled
  // the two-eye and the first_hit blends at 64 registers)
  constexpr int kListUnroll = kEyes == 1 && !kFirstHit ? 4 : 2;
  // the staged round, eye e's records at sr[e * stage ..]: dynamic shared
  // memory of kEyes * stage Recs (Plan::smem), so that a small CTA takes
  // only what its round needs
  extern __shared__ float4 split_rounds[];
  Rec* const sr = reinterpret_cast<Rec*>(split_rounds);
  __shared__ int vote[2];
  // kCull: each warp's box, the warps each staged record can reach (bit e
  // * kSplitWarps + w: eye e, warp w), and each warp's list of them
  __shared__ float4 box[kSplitWarps];
  __shared__ uint32_t reach[kBatch];
  __shared__ uint8_t listed[kEyes][kSplitWarps][kBatch];

  const int t = threadIdx.x;
  const int threads = static_cast<int>(blockDim.x);
  int stage = kBatch;  // the largest power of two <= min(threads, kBatch)
  while (stage > threads) stage >>= 1;
  const int slot = blockIdx.x / sp.ctas;
  const int rank = blockIdx.x - slot * sp.ctas;
  const int tile = sp.order != nullptr ? sp.order[slot] : slot;
  const bool large = sp.exits != nullptr;
  const bool cluster = sp.ctas > 1 && !large;
  const int n_tiles = static_cast<int>(gridDim.x) / sp.ctas;
  const int tx = tile % tiles_x, ty = tile / tiles_x;
  const int pix = tile_w * tile_h;
  // the thread's pixel (lx, ly), and whether it lies in the tile: lanes
  // past the tile's edge are idle (see kFar)
  const int gw = rank * (threads / 32) + t / 32, lane = t % 32;
  int lx, ly;
  bool live;
  if (sp.warp_w == 0) {
    const int p = gw * 32 + lane;
    ly = p / tile_w;
    lx = p - ly * tile_w;
    live = p < pix;
  } else {
    const int bh = 32 / sp.warp_w;
    const int bpr = (tile_w + sp.warp_w - 1) / sp.warp_w;  // blocks a row
    lx = (gw % bpr) * sp.warp_w + lane % sp.warp_w;
    ly = (gw / bpr) * bh + lane / sp.warp_w;
    live = lx < tile_w && ly < tile_h;
  }
  const int x = tx * tile_w + lx, y = ty * tile_h + ly;
  const bool out = live && x < width && y < height;  // writes the image
  // An idle lane evaluates every record at a point kFar pixels away: its q
  // is +inf (the linear forms' coefficients are at most 1e4, the means
  // f16), so its alpha is exactly 0 and it lies outside every cutoff; its
  // transmittance starts at 0, so it never holds the tile's exit open.
  constexpr float kFar = 1e30f;
  float pxf, pyf;
  if (!live) {
    pxf = pyf = kFar;
  } else if (coord_x != nullptr) {
    const int p = ly * tile_w + lx;
    pxf = coord_x[static_cast<size_t>(tx) * pix + p];
    pyf = coord_y[static_cast<size_t>(ty) * pix + p];
  } else {
    pxf = static_cast<float>(lx) + static_cast<float>(tx * tile_w);
    pyf = static_cast<float>(ly) +
          static_cast<float>((ty + tile_row_offset) * tile_h);
  }

  const int start = starts[tile];
  const int end = start + counts[tile];
  const int base = (start / kBlock) * kBlock;
  float trans[kEyes], acc_r[kEyes], acc_g[kEyes], acc_b[kEyes], acc_d[kEyes];
  bool hit[kEyes];
#pragma unroll
  for (int e = 0; e < kEyes; ++e) {
    trans[e] = live ? 1.0f : 0.0f;
    acc_r[e] = acc_g[e] = acc_b[e] = acc_d[e] = 0.0f;
    hit[e] = false;
  }
  int first = base;     // the rank the walk starts at
  int stop = INT_MAX;   // kResume: the rank after the tile's exit batch
  if constexpr (kResume) {
    stop = sp.exits[tile];
    first = sp.exits[n_tiles + blockIdx.x];
    if (first >= stop) return;  // the CTA stopped with its tile
    // the state the first launch left: colour in the image, the rest in
    // sp.state; a lane outside the image keeps its start (it neither
    // writes nor, here, votes)
    if (out) {
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        const size_t p =
            static_cast<size_t>(y) * (kEyes * width) + e * width + x;
        const float4 c = reinterpret_cast<const float4*>(color)[p];
        const uint2 s = sp.state[p];
        acc_r[e] = c.x;
        acc_g[e] = c.y;
        acc_b[e] = c.z;
        trans[e] = __uint_as_float(s.x & 0x7FFFFFFFu);
        hit[e] = (s.x >> 31) != 0;
        acc_d[e] = __uint_as_float(s.y);
      }
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
  const int warp = t / 32, warps = threads / 32;
  if constexpr (kCull) {
    const float inf = __int_as_float(0x7F800000);
    float x0 = live ? pxf : inf, x1 = live ? pxf : -inf;
    float y0 = live ? pyf : inf, y1 = live ? pyf : -inf;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x0 = fminf(x0, __shfl_xor_sync(0xFFFFFFFFu, x0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(0xFFFFFFFFu, x1, o));
      y0 = fminf(y0, __shfl_xor_sync(0xFFFFFFFFu, y0, o));
      y1 = fmaxf(y1, __shfl_xor_sync(0xFFFFFFFFu, y1, o));
    }
    // a pixel coordinate that is not finite: every box the whole plane
    if (__syncthreads_or(live && !(isfinite(pxf) && isfinite(pyf)))) {
      x0 = y0 = -inf;
      x1 = y1 = inf;
    }
    if (lane == 0) box[warp] = make_float4(x0, y0, x1, y1);
    __syncthreads();
  }

  // the cluster's exit votes, one slot a batch parity (a CTA reads its
  // peers' slot of this batch before any CTA can pass the next barrier and
  // write that slot again)
  int parity = 0;
  int own_exit = INT_MAX;  // the rank after the CTA's own exit batch
  int g = entry_at(first);
  int g_next = entry_at(first + stage);
  fetch(g);
  for (int b0 = first; b0 < end; b0 += stage) {
    const int lo = max(b0, start) - b0, hi = min(b0 + stage, end) - b0;
    if (g >= 0) {
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        const Rec r = decode_record(raw[4 * e], raw[4 * e + 1],
                                    raw[4 * e + 2], raw[4 * e + 3],
                                    theta_unit, inv255);
        sr[e * stage + t] = r;
        if constexpr (kCull) {
          // r2 >= 0 (an opacity of 0 has lop -inf), so that a box of the
          // whole plane reaches every record
          const float r2 =
              kCutoff ? r2_cutoff : fmaxf(2.0f * (r.b.z - kExpZero), 0.0f);
          bits |= reach_mask(r, raw[4 * e + 1], raw[4 * e + 2], r2, box,
                             warps) << (e * kSplitWarps);
        }
      }
      if constexpr (kCull) reach[t] = bits;
    }
    __syncthreads();
    g = g_next;
    g_next = entry_at(b0 + 2 * stage);
    fetch(g);

    // record k of the round, eye e, on the thread's pixel
    auto composite = [&](int e, int k) {
      const float4 A = sr[e * stage + k].a;
      const float4 B = sr[e * stage + k].b;
      const float dx = pxf - A.x;
      const float dy = pyf - A.y;
      const float u = A.z * dx + A.w * dy;
      const float v = B.x * dx + B.y * dy;
      const float q = u * u + v * v;
      const bool cut = kCutoff && q > r2_cutoff;
      if constexpr (kCutoff) {
        if (!__any_sync(0xFFFFFFFFu, !cut)) return;
      }
      const float4 Cc = sr[e * stage + k].c;
      float alpha = jmin(expf(q * -0.5f + B.z), 0.99f);
      if (cut) alpha = 0.0f;
      const float w = alpha * trans[e];
      acc_r[e] = acc_r[e] + w * Cc.x;
      acc_g[e] = acc_g[e] + w * Cc.y;
      acc_b[e] = acc_b[e] + w * Cc.z;
      if constexpr (kFirstHit) {
        // acc_d holds the first hit's depth
        if (!hit[e] && alpha > kFirstHitAlpha) {
          hit[e] = true;
          acc_d[e] = B.w;
        }
      } else {
        acc_d[e] = acc_d[e] + w * B.w;
      }
      trans[e] = trans[e] * (1.0f - alpha);
    };
    if constexpr (kCull) {
      // the warp lists, eye by eye, the round's records that reach it, and
      // composites those alone (an eye's records stay in order; the eyes'
      // sums never meet)
#pragma unroll
      for (int e = 0; e < kEyes; ++e) {
        int n = 0;
        for (int c = 0; c < stage; c += 32) {
          const int k = c + lane;
          const bool in = k >= lo && k < hi &&
                          ((reach[k] >> (e * kSplitWarps + warp)) & 1u) != 0;
          const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, in);
          if (in) {
            listed[e][warp][n + __popc(ballot & ((1u << lane) - 1u))] =
                static_cast<uint8_t>(k);
          }
          n += __popc(ballot);
        }
        __syncwarp();
#pragma unroll kListUnroll
        for (int i = 0; i < n; ++i) composite(e, listed[e][warp][i]);
      }
    } else {
      for (int k = lo; k < hi; ++k) {
#pragma unroll
        for (int e = 0; e < kEyes; ++e) composite(e, k);
      }
    }
    // barrier (also protects the shared round); at the end of each batch
    // of kBatch records the tile-level early exit
    if (stage < kBatch && (b0 + stage - base) % kBatch != 0) {
      __syncthreads();
      continue;
    }
    if constexpr (kResume) {
      // no vote: the first launch found the tile's exit batch
      if (b0 + stage >= stop) break;
      __syncthreads();
      continue;
    }
    bool open = false;  // the thread's pixel not below the exit
#pragma unroll
    for (int e = 0; e < kEyes; ++e) {
      open = open || !(trans[e] < min_transmittance);
    }
    int any_open = __syncthreads_or(open);
    if (cluster) {
      cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
      if (t == 0) vote[parity] = any_open;
      cl.sync();
      for (int r = 0; r < sp.ctas; ++r) {
        any_open |= *cl.map_shared_rank(&vote[parity], r);
      }
      parity ^= 1;
    }
    if (!any_open) {
      own_exit = b0 + stage;
      break;
    }
  }
  if (cluster) {
    // no CTA leaves while a peer may still read its votes
    cooperative_groups::this_cluster().sync();
  }
  const bool keep = !kResume && large && own_exit != INT_MAX;
  if (!kResume && large && t == 0) {
    sp.exits[n_tiles + blockIdx.x] = own_exit;
    atomicMax(sp.exits + tile, own_exit);
  }

  if (out) {
#pragma unroll
    for (int e = 0; e < kEyes; ++e) {
      const size_t p =
          static_cast<size_t>(y) * (kEyes * width) + e * width + x;
      float4 c;
      c.x = acc_r[e];
      c.y = acc_g[e];
      c.z = acc_b[e];
      c.w = 1.0f - trans[e];
      reinterpret_cast<float4*>(color)[p] = c;
      if (depth_mode == kDepthNormalized) {
        depth[p] = acc_d[e] / jmax(c.w, 1e-6f);
      } else if (depth_mode != kDepthNone) {
        depth[p] = acc_d[e];
      }
      if (keep) {
        sp.state[p] = make_uint2(__float_as_uint(trans[e]) |
                                     (hit[e] ? 0x80000000u : 0u),
                                 __float_as_uint(acc_d[e]));
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
  blend_tile<kEyes, kThreads, kPPT, kFirstHit, kCutoff>(
      key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h, width,
      height, tile_row_offset, depth_mode, theta_unit, inv255,
      min_transmittance, r2_cutoff, coord_x, coord_y, color, depth);
}

// The split-layout entries (see split_tile): the walk from the span's
// start, and the large-tile resume.  Two CTAs of kSplitWarps warps an SM
// at most 64 registers a thread.
template <int kEyes, bool kFirstHit, bool kCutoff, bool kCull>
__global__ void __launch_bounds__(kSplitWarps * 32, 2)
general_blend_kernel(const uint32_t* __restrict__ key_words,
                     uint32_t idx_mask, WordPtrs W,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ counts, int tiles_x,
                     int tile_w, int tile_h, int width, int height,
                     int tile_row_offset, int depth_mode, float theta_unit,
                     float inv255, float min_transmittance, float r2_cutoff,
                     const float* __restrict__ coord_x,
                     const float* __restrict__ coord_y,
                     float* __restrict__ color, float* __restrict__ depth,
                     Split sp) {
  split_tile<kEyes, kFirstHit, kCutoff, false, kCull>(
      key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h, width,
      height, tile_row_offset, depth_mode, theta_unit, inv255,
      min_transmittance, r2_cutoff, coord_x, coord_y, color, depth, sp);
}

template <int kEyes, bool kFirstHit, bool kCutoff>
__global__ void __launch_bounds__(kLargeWarps * 32, 3)
resume_blend_kernel(const uint32_t* __restrict__ key_words,
                    uint32_t idx_mask, WordPtrs W,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ counts, int tiles_x,
                    int tile_w, int tile_h, int width, int height,
                    int tile_row_offset, int depth_mode, float theta_unit,
                    float inv255, float min_transmittance, float r2_cutoff,
                    const float* __restrict__ coord_x,
                    const float* __restrict__ coord_y,
                    float* __restrict__ color, float* __restrict__ depth,
                    Split sp) {
  split_tile<kEyes, kFirstHit, kCutoff, true, true>(
      key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h, width,
      height, tile_row_offset, depth_mode, theta_unit, inv255,
      min_transmittance, r2_cutoff, coord_x, coord_y, color, depth, sp);
}

using BlendFn = decltype(&blend_kernel<1, 256, 1, false, false>);
using SplitFn = decltype(&general_blend_kernel<1, false, false, false>);

// The 8x4-block instance for a tile of kPix pixels: a thread a pixel up to
// 512 pixels (64 to 512 threads), and 512 threads of two pixels each at
// 32x32 (1024 threads a CTA would leave a thread 64 registers).
template <int kEyes, int kPix, bool kFirstHit, bool kCutoff>
BlendFn blend_for(int* threads) {
  constexpr int kPPT = kPix > 512 ? kPix / 512 : 1;
  *threads = kPix / kPPT;
  return blend_kernel<kEyes, kPix / kPPT, kPPT, kFirstHit, kCutoff>;
}

template <int kEyes, bool kFirstHit, bool kCutoff>
BlendFn pick_pixels(int pix, int* threads) {
  switch (pix) {
    case 64: return blend_for<kEyes, 64, kFirstHit, kCutoff>(threads);
    case 128: return blend_for<kEyes, 128, kFirstHit, kCutoff>(threads);
    case 256: return blend_for<kEyes, 256, kFirstHit, kCutoff>(threads);
    case 512: return blend_for<kEyes, 512, kFirstHit, kCutoff>(threads);
    default: return blend_for<kEyes, 1024, kFirstHit, kCutoff>(threads);
  }
}

// The 8x4-block instance of a tile of pix pixels (one eye, or two with a
// cutoff).
BlendFn pick_blocks(bool two, bool first_hit, bool cutoff, int pix,
                    int* threads) {
  if (two) {
    return first_hit ? pick_pixels<2, true, true>(pix, threads)
                     : pick_pixels<2, false, true>(pix, threads);
  }
  if (cutoff) {
    return first_hit ? pick_pixels<1, true, true>(pix, threads)
                     : pick_pixels<1, false, true>(pix, threads);
  }
  return first_hit ? pick_pixels<1, true, false>(pix, threads)
                   : pick_pixels<1, false, false>(pix, threads);
}

// The split layout's two entries for one pairing of eyes, depth and cutoff.
struct SplitPair {
  SplitFn walk, resume;
};

template <int kEyes, bool kFirstHit, bool kCutoff>
SplitPair split_for(bool cull) {
  return {cull ? general_blend_kernel<kEyes, kFirstHit, kCutoff, true>
               : general_blend_kernel<kEyes, kFirstHit, kCutoff, false>,
          resume_blend_kernel<kEyes, kFirstHit, kCutoff>};
}

SplitPair pick_split(bool two, bool first_hit, bool cutoff, bool cull) {
  if (two) {
    if (cutoff) {
      return first_hit ? split_for<2, true, true>(cull)
                       : split_for<2, false, true>(cull);
    }
    return first_hit ? split_for<2, true, false>(cull)
                     : split_for<2, false, false>(cull);
  }
  if (cutoff) {
    return first_hit ? split_for<1, true, true>(cull)
                     : split_for<1, false, true>(cull);
  }
  return first_hit ? split_for<1, true, false>(cull)
                   : split_for<1, false, false>(cull);
}

// How a frame's tiles are blended: the 8x4-block instance (blocks), or the
// split layout's CTAs (layout.ctas a tile of threads each, a cluster when
// 1 < ctas and the tile holds at most kMaxPix pixels, the large-tile
// path's two launches above; cull: records culled by warp).
struct Plan {
  bool blocks, large, cull;
  BlendFn block;
  SplitPair split;
  Layout layout;
  int threads;
  size_t smem;  // the split layout's dynamic shared memory (split_tile)
};

// The plan of a tile of sides tile_side_ok takes.
Plan plan_blend(bool two, bool first_hit, bool cutoff, int tile_w,
                int tile_h) {
  Plan plan{};
  const int pix = tile_w * tile_h;
  plan.blocks = block_side(tile_w) && block_side(tile_h) && !(two && !cutoff);
  plan.large = pix > kMaxPix;
  if (plan.blocks) {
    plan.block = pick_blocks(two, first_hit, cutoff, pix, &plan.threads);
    plan.layout = {kWarpW, plan.threads / 32, 1};
    return plan;
  }
  plan.cull = cutoff || pix > kCullPix;
  plan.split = pick_split(two, first_hit, cutoff, plan.cull);
  plan.layout = split_layout(tile_w, tile_h);
  plan.threads = 32 * plan.layout.cta_warps;
  int stage = kBatch;  // split_tile's round
  while (stage > plan.threads) stage >>= 1;
  plan.smem = static_cast<size_t>(two ? 2 : 1) * stage * sizeof(Rec);
  return plan;
}

// Counts the floats from bits first to bits last (negative floats: their
// magnitude grows with their bits) whose expf is not exactly 0, compiled
// as the blends' expf is.
__global__ void expf_zero_kernel(uint32_t first, uint32_t last,
                                 unsigned int* nonzero) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  unsigned int n = 0;
  for (uint64_t b = first + blockIdx.x * blockDim.x + threadIdx.x; b <= last;
       b += stride) {
    if (expf(__uint_as_float(static_cast<uint32_t>(b))) != 0.0f) ++n;
  }
  if (n != 0) atomicAdd(nonzero, n);
}

}  // namespace

// The check behind kExpZero: adds to *nonzero (device memory) the number
// of floats from kExpZero down to -inf whose expf is not exactly 0.
extern "C" int gsm_expf_zero_check(unsigned int* nonzero,
                                   cudaStream_t stream) {
  uint32_t first;
  std::memcpy(&first, &kExpZero, sizeof first);
  expf_zero_kernel<<<1024, 256, 0, stream>>>(first, 0xFF800000u, nonzero);
  return static_cast<int>(cudaGetLastError());
}

// sorted_key: (capacity,) int64 sort keys (key2 in the low 32 bits, the
// entry index in its low idx_bits); words: 4 * n_eyes pointers to the (N,)
// int32 word rows of the entry table; tile_w, tile_h: 1 to 4096 pixels
// (tile_side_ok); depth_mode: a DepthMode; coord_x (tiles_x, tile_w *
// tile_h) and coord_y (tiles_y, tile_w * tile_h) the foveated pixel
// coordinates, or both null; tile_row_offset >= 0 (0 with coordinate
// tables); color (H, n_eyes * W, 4), depth (H, n_eyes * W) unless
// depth_mode is none.  r2_cutoff >= 0 (0: no cutoff).  A tile of more
// than kMaxPix pixels takes scratch: exits, tiles_x * tiles_y * (1 + its
// CTAs a tile, gsm_blend_layout) int32, state, H * n_eyes * W * 2 uint32
// (any contents: gsm_blend zeroes what it needs on the stream), and order,
// the tiles_x * tiles_y tile indices in launch order; all are unused (may
// be null) for other tiles.  Every pairing of eyes, cutoff, depth mode and
// pixel coordinates takes every tile.  One launch, a cluster launch, or
// above kMaxPix pixels a memset and two launches.
extern "C" int gsm_blend(const int64_t* sorted_key, int idx_bits,
                         const void* const* words, int n_words,
                         const int32_t* starts, const int32_t* counts,
                         int tiles_x, int tiles_y, int width, int height,
                         int tile_row_offset, int tile_w, int tile_h,
                         int depth_mode, float theta_unit, float inv255,
                         float min_transmittance, float r2_cutoff,
                         const float* coord_x, const float* coord_y,
                         float* color, float* depth, int32_t* exits,
                         uint32_t* state, const int32_t* order,
                         cudaStream_t stream) {
  const bool two = n_words == 8;
  const bool cutoff = r2_cutoff > 0.0f;
  if ((n_words != 4 && !two) || idx_bits < 1 || idx_bits > 32 ||
      !(r2_cutoff >= 0.0f) || !tile_side_ok(tile_w) ||
      !tile_side_ok(tile_h) || depth_mode < kDepthNone ||
      depth_mode > kDepthNormalized || tile_row_offset < 0 ||
      (tile_row_offset != 0 && coord_x != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = plan_blend(two, depth_mode == kDepthFirstHit, cutoff,
                               tile_w, tile_h);
  const int ctas = plan.layout.ctas;
  const WordPtrs W = load_words(words, n_words);
  const uint32_t idx_mask =
      idx_bits == 32 ? 0xFFFFFFFFu : ((1u << idx_bits) - 1u);
  const uint32_t* key_words = reinterpret_cast<const uint32_t*>(sorted_key);
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  if (plan.blocks) {
    plan.block<<<n_tiles, plan.threads, 0, stream>>>(
        key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h,
        width, height, tile_row_offset, depth_mode, theta_unit, inv255,
        min_transmittance, r2_cutoff, coord_x, coord_y, color, depth);
    return static_cast<int>(cudaGetLastError());
  }
  const long long grid = static_cast<long long>(n_tiles) * ctas;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Split sp{plan.layout.warp_w, ctas, nullptr, nullptr, nullptr};
  if (plan.large) {
    if (exits == nullptr || state == nullptr || order == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sp.exits = exits;
    sp.state = reinterpret_cast<uint2*>(state);
    sp.order = order;
    cudaError_t err = cudaMemsetAsync(
        exits, 0, static_cast<size_t>(n_tiles) * sizeof(int32_t), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const SplitFn kernels[2] = {plan.split.walk, plan.split.resume};
    for (const SplitFn kernel : kernels) {
      kernel<<<static_cast<unsigned>(grid), plan.threads, plan.smem, stream>>>(
          key_words, idx_mask, W, starts, counts, tiles_x, tile_w, tile_h,
          width, height, tile_row_offset, depth_mode, theta_unit, inv255,
          min_transmittance, r2_cutoff, coord_x, coord_y, color, depth, sp);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaSuccess);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
  config.blockDim = dim3(plan.threads);
  config.dynamicSmemBytes = plan.smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = ctas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, plan.split.walk, key_words, idx_mask, W, starts, counts,
      tiles_x, tile_w, tile_h, width, height, tile_row_offset, depth_mode,
      theta_unit, inv255, min_transmittance, r2_cutoff, coord_x, coord_y,
      color, depth, sp);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The split layout gsm_blend gives a tile (the same arguments): out[0 ..
// 3] = warp_w (0: strips), warps a CTA, CTAs a tile, and 1 where records
// are culled by warp, else 0.  Returns 1, 0 for a tile the 8x4-block
// instances take (out untouched), -1 for arguments gsm_blend refuses.
// Host code only: it needs no card.
extern "C" int gsm_blend_layout(int n_eyes, float r2_cutoff, int tile_w,
                                int tile_h, int* out) {
  if ((n_eyes != 1 && n_eyes != 2) || !(r2_cutoff >= 0.0f) ||
      !tile_side_ok(tile_w) || !tile_side_ok(tile_h)) {
    return -1;
  }
  const Plan plan =
      plan_blend(n_eyes == 2, false, r2_cutoff > 0.0f, tile_w, tile_h);
  if (plan.blocks) return 0;
  out[0] = plan.layout.warp_w;
  out[1] = plan.layout.cta_warps;
  out[2] = plan.layout.ctas;
  out[3] = plan.cull ? 1 : 0;
  return 1;
}

// The launches gsm_blend makes for a tile (the same arguments): for each,
// out[4k .. 4k + 3] = its threads a CTA, CTAs a tile, CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at that CTA size, the
// cluster aside) and registers a thread (cudaFuncGetAttributes).  Returns
// the number of launches (1 or 2), or -1 for arguments gsm_blend refuses
// or a runtime error.
extern "C" int gsm_blend_occupancy(int n_eyes, int depth_mode,
                                   float r2_cutoff, int tile_w, int tile_h,
                                   int* out) {
  if ((n_eyes != 1 && n_eyes != 2) || !(r2_cutoff >= 0.0f) ||
      !tile_side_ok(tile_w) || !tile_side_ok(tile_h)) {
    return -1;
  }
  const Plan plan = plan_blend(n_eyes == 2, depth_mode == kDepthFirstHit,
                               r2_cutoff > 0.0f, tile_w, tile_h);
  const void* fns[2] = {
      plan.blocks ? reinterpret_cast<const void*>(plan.block)
                  : reinterpret_cast<const void*>(plan.split.walk),
      reinterpret_cast<const void*>(plan.split.resume)};
  const int n = plan.large ? 2 : 1;
  for (int k = 0; k < n; ++k) {
    cudaFuncAttributes a;
    int blocks = 0;
    if (cudaFuncGetAttributes(&a, fns[k]) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fns[k], plan.threads, plan.smem) != cudaSuccess) {
      return -1;
    }
    out[4 * k] = plan.threads;
    out[4 * k + 1] = plan.layout.ctas;
    out[4 * k + 2] = blocks;
    out[4 * k + 3] = a.numRegs;
  }
  return n;
}

// ---------------------------------------------------------------------------
// The outputs of a captured frame (pipelines/replay.py).  A frame's CUDA
// graph holds its blend launches with the colour and depth pointers of the
// frame it was captured on; before each launch the host points them at the
// next frame's own new tensors (cudaGraphExecKernelNodeSetParams), so that
// a replay writes what its caller keeps and no frame's outputs are ever
// written again.  Every blend entry takes colour and depth as its
// arguments kColorArg and kColorArg + 1.
// ---------------------------------------------------------------------------

namespace {

constexpr int kColorArg = 18;
constexpr int kMaxBlendArgs = 21;

// A blend launch of a graph: its node, its launch as captured and its
// argument count.
struct OutputNode {
  cudaGraphNode_t node;
  cudaKernelNodeParams launch;
  int nargs;
};

// The argument count of ``func`` if it is a blend entry (20: the 8x4-block
// instances; 21: the split layout's, with its Split), else 0.
int blend_args(const void* func) {
  constexpr int kPix[5] = {64, 128, 256, 512, 1024};
  for (int two = 0; two < 2; ++two) {
    for (int first_hit = 0; first_hit < 2; ++first_hit) {
      for (int cutoff = 0; cutoff < 2; ++cutoff) {
        int threads;
        for (const int pix : kPix) {
          if (reinterpret_cast<const void*>(pick_blocks(
                  two, first_hit, cutoff, pix, &threads)) == func) {
            return 20;
          }
        }
        for (int cull = 0; cull < 2; ++cull) {
          const SplitPair sp = pick_split(two, first_hit, cutoff, cull);
          if (reinterpret_cast<const void*>(sp.walk) == func ||
              reinterpret_cast<const void*>(sp.resume) == func) {
            return kMaxBlendArgs;
          }
        }
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" size_t gsm_output_node_bytes() { return sizeof(OutputNode); }

// The blend launches of ``graph`` (a cudaGraph_t) that write ``color``:
// writes up to ``max_nodes`` OutputNodes into ``out`` and their number into
// ``count``.  cudaErrorInvalidValue where there is none or more than
// ``max_nodes``.  ``out`` reads the nodes' arguments from the graph: keep
// the graph alive.
extern "C" int gsm_output_nodes(void* graph, const void* color, void* out,
                                int max_nodes, int* count) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (err = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  std::vector<OutputNode> found;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(node, &type)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (type != cudaGraphNodeTypeKernel) {
      continue;
    }
    cudaKernelNodeParams p;
    err = cudaGraphKernelNodeGetParams(node, &p);
    if (err == cudaErrorInvalidDeviceFunction) {
      // a kernel of another module, each with its own runtime: no blend
      cudaGetLastError();
      continue;
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int nargs = blend_args(p.func);
    if (nargs > 0 &&
        *static_cast<void* const*>(p.kernelParams[kColorArg]) == color) {
      found.push_back({node, p, nargs});
    }
  }
  if (found.empty() || static_cast<int>(found.size()) > max_nodes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  memcpy(out, found.data(), found.size() * sizeof(OutputNode));
  *count = static_cast<int>(found.size());
  return static_cast<int>(cudaSuccess);
}

// Point the ``count`` blend launches ``nodes`` (gsm_output_nodes) of
// ``exec`` (the graph's cudaGraphExec_t) at ``color`` and, unless null,
// ``depth``, for the graph's next launches; their other arguments stay as
// captured.
extern "C" int gsm_set_outputs(void* exec, const void* nodes, int count,
                               float* color, float* depth) {
  for (int k = 0; k < count; ++k) {
    OutputNode on;
    memcpy(&on, static_cast<const char*>(nodes) + k * sizeof(OutputNode),
           sizeof(on));
    void* args[kMaxBlendArgs];
    for (int i = 0; i < on.nargs; ++i) {
      args[i] = on.launch.kernelParams[i];
    }
    args[kColorArg] = &color;
    if (depth != nullptr) {
      args[kColorArg + 1] = &depth;
    }
    cudaKernelNodeParams p = on.launch;
    p.kernelParams = args;
    p.extra = nullptr;
    const cudaError_t err = cudaGraphExecKernelNodeSetParams(
        static_cast<cudaGraphExec_t>(exec), on.node, &p);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}
