#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gsm_renderer_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. Build the CUDA kernels from ``gsm_renderer_tpu_torch/csrc`` (one nvcc per
   source, in parallel); print each kernel's ``-Xptxas -v`` registers,
   shared memory and spills (a spill in the blend, the expand, prep or the
   row expand fails the run), the SASS counts of the blend's composite
   loop where ``cuobjdump``
   sits beside ``nvcc``, each blend launch's registers and resident warps
   an SM at the BLEND_AB tiles (``gsm_blend_occupancy``), and the card's
   name and power limit; fails unless expf is exactly 0 at every float
   below the blend's zero exponent (``gsm_expf_zero_check``: the record
   culling of the blend without a cutoff relies on it).
2. The headline frame through the user entry point
   ``DepthFirstRenderer(config).render`` with the default configuration
   (row expansion on): 1M gaussians, SH3, float32, 1920x1080.  Two capacity
   lock-in frames, 3 warm-up and 10 timed frames (CUDA events); every
   kernel's launch count is set to 0 just before these frames and read just
   after.  Requires overflow 0, a finite image, some non-black pixels, and
   the colour and depth bit-equal to the same scene rendered with
   ``row_expand=False`` (8 frames, with launch counts of their own).  Each
   frame loop of phases 2-4f also prints its host/device split
   (``frame_split``: the host's enqueue time per frame, and the device time
   of frames queued back to back).  Each traced frame (phases 2-4f) prints
   its device time by stage, every kernel attributed to one, and fails if
   it launched a separate scan kernel (prep and the row expand scan in
   their own pass).
3. The realistic heavy-tailed scene (``generate_realistic_gaussians``, 1M,
   SH3) through a PLY file: ``io.ply.write_ply`` to a temporary file,
   ``load_ply`` with the native decoder (which must build and load), the
   NumPy decode of the same file held to it (tests/test_io.py's bounds, or
   2 float32 ulps: the two decoders' exp differ), the file size, the write
   and both load times printed, the file deleted.  The loaded scene
   (recentred, camera before the nearest splats, far 80) is rendered with
   rows on and off: frame times, slot totals and a device-time split by
   kernel for each; requires bit-equal images, overflow 0 and a smaller
   rows-on slot total.
3f. One headline frame each from the headline scene written as a
   compressed PLY (loaded with the native decoder) and as a .splat, and
   from the headline camera written to a cameras.json and read back by
   ``io.poses.load_cameras_json``: launch counts of its own, overflow 0,
   finite, non-black; file sizes and load times printed.
3p. ``profiling.profile_depth_first_stages`` on the headline scene at the
   rows-off frame's capacity: every stage > 0 and the total within 15% of
   the rows-off frame's queued device time (``frame_split`` of phase 2),
   printed side by side.
4. Side-by-side stereo through ``render_stereo``: the headline scene at
   1920x1080 per eye (a 1080x3840 frame), its own launch counts; requires
   overflow 0, a finite frame and both halves non-black.
4f. Foveated stereo through ``render_stereo_foveated``: the same scene and
   rig, the target ``make_rate_maps(1920, 1080, min_rate=0.4, radius=0.3)``
   (physical 1767x994 per eye, a 994x3534 frame); 2 lock-in, 3 warm-up and
   10 timed frames with launch counts of their own (stereo_project, prep,
   expand and blend each > 0; bounds_gather runs fused into the prep);
   requires overflow 0, a finite frame and both halves non-black; prints its
   frame times, slot total and device split beside the stereo frame's, and
   one timed line at min_rate 0.15.
4d. The 16-bit-depth-key renderers on the headline scene:
   ``GlobalRenderer(config).render`` (32x16 tiles), ``LocalRenderer`` (16x16,
   per-tile clamp at 2048, first-hit depth) and ``DepthFirstRenderer`` with
   ``depth_sort_key_precision=BITS16`` under tile ids BITS16 and BITS32;
   each 2 lock-in, 3 warm-up and 10 timed frames with launch counts of its
   own (project, prep, expand and blend each > 0), overflow 0, finite,
   non-black, its split and a traced device split by stage.  Requires the
   two DepthFirst BITS16 frames bit-equal, the Local colour bit-equal to
   theirs on every tile the clamp leaves alone (prints the clamped tiles),
   and the Global colour within a mean |d| of 0.01 of the headline frame's.
   Local also renders the realistic scene of phase 3 (its clamped tiles
   printed).  One frame runs under
   ``torch.cuda.set_sync_debug_mode("warn")`` and one under a host-clock
   probe with the device held (``host_syncs``, ``host_waits``; the latter
   for the stereo frame too): each prints where the host waited, if it
   did.
4h. The HardwareRenderer on the headline scene: ``HardwareRenderer(config)
   .render`` (full rects: prep and the expand in mode "none", the blend with
   the r^2 <= 9 cutoff and normalized depth; 8 x gaussians of capacity
   before the lock-in), 2 lock-in, 3 warm-up and 10 timed frames with
   launch counts of its own (project, prep, expand and blend each > 0),
   overflow 0, finite, non-black, no row total, its split and a traced
   device split by stage; the INSTANCED and back_to_front frames bit-equal
   to it, its colour within a mean |d| of 0.01 of the headline's.  Then
   ``render_stereo`` and ``render_stereo_foveated`` through the same
   renderer (launch counts, times, split, trace): colour bit-equal to the
   DepthFirst frames of phases 4 and 4f, depth bit-equal to their depth
   over max(alpha, 1e-6).
4t. The frame functions at other tiles and frame options, at full width on
   the headline scene (1M gaussians, SH3, 1920x1080, the headline camera
   and stereo rig): ``depth_first_frame`` with rows at 8x8, 16x8, 8x16,
   32x32 and 32x16 (each bit-equal to rows off), the stereo frame at 32x16
   and 8x8, the foveated frame (min_rate 0.4; 8-pixel sides would pass the
   127-tile bounds table at 1080p, which JAX refuses too) at 32x16 and
   32x32, the Hardware frame and ``global_frame(exact_tile_test=False)`` at
   32x16, and ``depth_first_frame(max_per_tile=2048)`` on the realistic
   scene of phase 3 (tiles clamp; equal to the unclamped frame on the
   others, the same slot total).  Each at a capacity probed from its slot
   total (``fit_capacity``), with launch counts of its own (1 warm-up and
   5 timed frames), the frame gate (overflow 0, finite, non-black), its
   split and a traced device split; then every kernel mode of each frame
   on its own tensors against its plain version (integers bit-equal, the
   whole-frame blend bit-equal, the staged frame equal to the frame
   function's), each a kernel row named with its tile (``blend.8x8``,
   ``prep.warped.32x32``, ``expand.none.d16_32``, ...).
4o. The same at tile sides that are not powers of two: mono with rows at
   24x24, 12x12, 20x12, 48x16, 64x64 (the blend's cluster of eight CTAs)
   and 7x5 (rows off), stereo at 24x24 with the two-eye blend without a
   cutoff held bit-equal on its tensors, foveated, Hardware and Local at
   24x24, Global at 48x16.
4L. The same at tile sides over 64 pixels, where a tile of more than 4096
   pixels takes the blend's large-tile path (CTAs without a cluster that
   blend to their own exits, then resume to the tile's): mono with rows at
   65x65 (the smallest tile on that path), 96x80, 128x64 and 128x128, each
   bit-equal to rows off; stereo at 96x96 with the two-eye blend without a cutoff on
   its tensors; foveated, Hardware and band (4m) at 128x128; Local at
   96x96; Global at 128x64 with and without the exact tile test.  Each
   kernel mode on each frame's tensors bit-equal to its plain version (the
   blends over the whole frame).
4m. The band-sharded frame (``parallel/multichip.py``) of the headline
   scene.  A world of one over NCCL in this process, with the KeyPlan and
   with the stable fallback (``use_keyplan=False``), and at 32x16 and 8x8
   tiles with the KeyPlan (8x8 at phase 4t's capacity): launch counts of
   its own (project, prep, prep_band, expand and blend each > 0), overflow
   0, colour and depth bit-equal to the headline frame (at 32x16 and 8x8 to
   ``depth_first_frame`` at that tile, rows off), frame times, split and
   trace beside the headline's rows-off frame.  On band 1 of 4, at 16x16,
   32x16 and 8x8 (the 8x8 rows with the world of one's launches): prep
   "band", the expand with a tile row offset and the blend with one, each
   bit-equal to its plain version (the blend over the whole band); over
   the whole frame's slots the tile-key expand against its plain version,
   and the stable sort timed beside the keys-only sort (the same ranks).
   Worlds of 2 and 4 over gloo, each rank a spawned process on this card,
   with equal bands and bands balanced from ``row_instance_histogram``
   (capacity: the padded count plus the largest band load, rounded up to
   4096), and in the world of 4 equal bands at 32x16 tiles: every rank
   launches each kernel of the path, overflow 0; the stitched image equals
   the mono frame of its tile (as above) bit for bit with the blend's
   early exit off, and within the exit threshold (1/255) with it on (a
   saturated tile stops at a batch end aligned to its band's sorted list;
   the pixels that differ are counted); a run at a capacity of 4096
   reports overflow 1 on every rank.  The band kernels' rows (at 32x16
   named with the suffix ``.32x16``) report the launches of rank 1 in the
   world of 4 with equal bands at their tile (band 1 of 4, the band they
   are checked on: a non-zero tile row offset), the tile-key expand's
   those of the world of one's stable frame.  The world of one also
   renders at phase 4o's 24x24 and phase 4L's 128x128 (bit-equal to the
   mono frame there), and the band kernels run at those tiles too (at
   128x128 with the world of one's launches).
4s. The stable-sort fallback: ``make_key_plan`` is None for 4M gaussians
   at 3840x2160, far 1000 (printed); that mono ``DepthFirstRenderer``
   frame (scale range halved from the headline's, so the splats cover as
   many pixels at 4K) with 2 lock-in, 3 warm-up and 10 timed frames, its
   own launch counts (no row expand), overflow 0, finite, non-black, its
   split and trace; its tile-key expand bit-equal to its plain version and
   the staged frame equal to the renderer's; and the headline scene
   through ``mono_packed_sorted`` with the plan set to None, bit-equal to
   the headline frame.
5. Each kernel and mode on the frames' own intermediate tensors (prep and
   expand both as the rows-on and as the rows-off frame run them, in their
   stereo modes, and in mode "warped" on the foveated frame's tensors with
   the bounds gather and the blend with pixel coordinates) against its
   plain PyTorch version on the card: integer outputs equal (counted
   mismatches capped at 1e-4 of the elements; none for the expand), float
   outputs within 1e-3 (the bounds gather's planes bit-equal, and they must
   reproduce the warped prep's mask; the warped prep is also checked with
   lod_min 5; the stereo and warped expands also with the plain tile key of
   the stable fallback, bit-equal to its plain version, the stable sort of
   its slots in the KeyPlan sort's order), the blends (reading records through the sorted keys) bit-equal
   on the 64 heaviest and 64 random tiles, the mono blend on the whole frame
   too.  Times each kernel, plain
   version, the instance sort and the tile ranges with CUDA events: kernels
   and library calls queued behind a sleep kernel, so that the host's
   per-call cost stays out; the plain versions, host-paced, as they run.
   Computes each kernel's bound from this run's inputs (for the dual-eye
   blends, the pairs within the r2 cutoff from the plain version's q).  For
   the blends and
   the bounds gather it also prints CUDA-event times of the same calls,
   back to back and with the L2 cache overwritten before each.  On the
   Global and Local frames' tensors: the projection's depth_key16 mode at
   32x16 and 16x16, prep and the expand at 32x16 over the 16-bit KeyPlan,
   the blend at 32x16 and with first_hit depth, each bit-equal to its plain
   version (whole frames for the blends, which must also reproduce the
   renderers' frames).  On the Hardware frames' tensors: prep and the
   expand in mode "none", the one-eye blend with the cutoff and normalized
   depth, the dual-eye blend with normalized depth, each bit-equal to its
   plain version over the whole frame and to the renderer's frame; the
   Hardware frame's instance sort timed.  The instance sort and tile
   ranges carry byte floors (one read and one write of the int64 keys; one
   read of the sorted keys).
5t. The expand on built entry tables (entries owning more slots than 4 of
   its CTAs, a run of 1-slot and culled entries, a row table's dead tail, a
   total equal to the capacity and one above it) in modes mono, stereo and
   warped, and in mode none with the tables' MASKED bits cleared and no
   mask: bit-equal to its plain version, overflow as the capacity says.
5p. Prep and the row expand on built inputs (``built_prep_inputs``: 1 to
   1,000,001 gaussians; all culled, all oversized, one lane of 32 tests in
   each warp of 1-test lanes, mixed): prep in mono ``count_rows`` and full
   rects, stereo, warped at lod_min 0 and 5, and none (no test: offsets
   alone); the row expand with the row
   capacity below, at and above the row total.  Three back-to-back calls
   must be equal, and the first within ``check_ints`` of the plain version;
   prints each mode's flip share and a digest of its outputs.
6. Small frames (20k gaussians, 512x384) on the card vs the same renderer on
   the CPU (plain versions): rows off, rows on, stereo, foveated (min_rate
   0.4), Global, Local, DepthFirst BITS16, and Hardware mono, BITS16,
   stereo and foveated; then the frame functions with rows at 8x8 and
   32x32, with ``max_per_tile`` 64, Global without the exact tile test,
   stereo and foveated at 8x8, phase 4o's tiles; and on a smaller scene
   (4,000 gaussians, 192x128) the mono frame at 65x16, 97x33, 256x256
   (one tile larger than the frame), 4096x1 and 1x4096; colour within
   1e-3; and at 4096x4096 its image bit-equal to the plain blend of its
   staged chain on the card.
   After phase 2 a torch.profiler trace of 10 headline frames prints the
   device busy time and the kernel time by name.
7. The last line is {"ok": true, "device": {...}}.

Without a CUDA device, or outside the repository, it prints no result and
exits 2.

``python3 chip_smoke.py --frames`` runs only the mono frame loops (the
headline and the realistic scene, rows on and off) with their host/device
split and traced idle share, and prints one JSON line: copied into a
checkout of another commit, it times that commit's package the same way.
``python3 chip_smoke.py --kernels`` runs phases 1, 2, 4, 4f, 4d (without
the realistic Local frame), 4h, 5 and 5p (not 4m and 4s) and
prints one JSON line of the kernel rows and the built-input flip shares and
digests, for the same use (it does not require the one-pass scan there).
``python3 chip_smoke.py --blends`` times every blend of the kernel table
on the split layout and the large-tile path (BLEND_AB: phases 4o, 4L and
4m's tiles and modes) on its frame function's own tensors, with a digest
of each image (equal digests across trees: bit-equal images), the device
split of its launches and their occupancy, and prints one ``{"blends":
...}`` line, for the same use (about two minutes;
scratch/blend_occupancy_probe.py gives a tree before it the occupancy
export).
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

# NVIDIA H100 SXM data sheet (dense, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# float32 operations per element, counted from the kernels' source
# (transcendentals, sqrt and division counted as one each)
PROJECT_FLOPS = 520        # per gaussian at SH3
STEREO_PROJECT_FLOPS = 860  # per gaussian at SH3: two eye chains, one SH
PREP_DECODE_FLOPS = 30     # per gaussian and eye: conic decode and cutoff
TILE_TEST_FLOPS = 65       # per minQuadRect <= cutoff test
ROW_SPAN_FLOPS = 75        # per oversized row: decode and closed-form span
EXPAND_DECODE_FLOPS = 30   # per tested slot and eye, plus one tile test
BLEND_DECODE_FLOPS = 30    # per record and eye decoded
BLEND_PAIR_FLOPS = 25      # per (pixel, record, eye) composited
BLEND_Q_FLOPS = 11         # per pair the r2 cutoff zeroes: dx, dy, u, v, q
BLEND_BOX_FLOPS = 12       # per (warp, record, eye) box test of a culling blend
BLEND_EXP_ZERO = -110.0    # csrc/blend.cu kExpZero: expf below it is 0
BLEND_REACH_MARGIN = 1.1   # csrc/blend.cu kReachMargin

KERNEL_SOURCES = {
    "project": ("gsm_renderer_tpu_torch/csrc/project.cu",
                "gsm_renderer_tpu/kernels/project.py:99"),
    "prep": ("gsm_renderer_tpu_torch/csrc/binning.cu",
             "gsm_renderer_tpu/kernels/expand.py:735"),
    "row_expand": ("gsm_renderer_tpu_torch/csrc/binning.cu",
                   "gsm_renderer_tpu/kernels/expand.py:915"),
    "expand": ("gsm_renderer_tpu_torch/csrc/binning.cu",
               "gsm_renderer_tpu/kernels/expand.py:550"),
    "blend": ("gsm_renderer_tpu_torch/csrc/blend.cu",
              "gsm_renderer_tpu/kernels/blend.py:335"),
    "stereo_project": ("gsm_renderer_tpu_torch/csrc/project.cu",
                       "gsm_renderer_tpu/kernels/project.py:493"),
    "bounds_gather": ("gsm_renderer_tpu_torch/csrc/binning.cu",
                      "gsm_renderer_tpu/kernels/expand.py:202"),
}
#: kernels whose -Xptxas -v report must show no spill
SPILL_CHECKED = ("blend_kernel", "general_blend_kernel", "resume_blend_kernel",
                 "expand_kernel", "prep_kernel", "row_expand_kernel")
#: the separate scan kernels of the prep and row expansion before the
#: one-pass scan; no frame may launch them
OLD_SCAN_KERNELS = ("scan_block_sums_kernel", "add_block_offsets_kernel")
#: (stage, substrings of its device kernels' names), first match wins; the
#: rest is "torch ops" (elementwise, fills, reductions, copies)
STAGE_KERNELS = (
    ("project", ("project_kernel",)),
    ("prep", ("prep_kernel",) + OLD_SCAN_KERNELS),
    ("row expand", ("row_expand_kernel",)),
    ("expand", ("expand_kernel",)),
    ("blend", ("blend_kernel",)),
    ("bounds gather", ("bounds_gather_kernel",)),
    ("instance sort", ("Radix", "radix", "Sort", "sort")),
    ("tile ranges", ("searchsorted",)),
)
#: the kernels each path must launch
MONO_ROWS_PATH = ("project", "prep", "row_expand", "expand", "blend")
MONO_RECTS_PATH = ("project", "prep", "expand", "blend")
STEREO_PATH = ("stereo_project", "prep", "expand", "blend")
FOVEATED_PATH = ("stereo_project", "prep", "expand", "blend")
D16_PATH = ("project", "prep", "expand", "blend")
HARDWARE_PATH = ("project", "prep", "expand", "blend")
BAND_PATH = ("project", "prep", "prep_band", "expand", "blend")
W, H = 1920, 1080
#: phase 4s's frame, where no tie-free KeyPlan fits: gaussians, width,
#: height, far plane
FALLBACK_N, FALLBACK_W, FALLBACK_H, FALLBACK_FAR = 4_000_000, 3840, 2160, 1000.0
#: the foveated rate maps of the JAX bench's foveated rows
FOV_MIN_RATE, FOV_RADIUS, FOV_MIN_RATE_LOW = 0.4, 0.3, 0.15


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int):
    """(last result, mean ms per call) over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end) / reps


def once_ms(torch, fn):
    """(result, ms) of one call, timed with CUDA events and no warm-up: the
    plain blends, which take seconds a call on the large frames."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def cold_cuda_ms(torch, fn, reps: int, device) -> float:
    """Mean ms per call over ``reps`` calls, each timed alone with CUDA
    events after a 64 MiB fill has overwritten the L2 cache (50 MB): the
    state a frame's stage finds after the stages before it."""
    flush = torch.empty(16 << 20, dtype=torch.float32, device=device)
    fn()
    total = 0.0
    for _ in range(reps):
        flush.fill_(0.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_kernel_stats(prof) -> dict:
    """(device ms, launches) of every CUDA kernel a profiler saw, by name."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms, count = out.get(e.key, (0.0, 0))
        out[e.key] = (ms + us / 1e3, count + e.count)
    return out


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond, measured once
    with CUDA events."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(torch, fn, reps: int):
    """(last result, device ms per call) over ``reps`` calls after one
    warm-up, timed with CUDA events.  A sleep kernel holds the device while
    the host enqueues the calls, so they run back to back and the time
    leaves out the host's per-call cost; where the host did not get ahead
    (a call that waits on the device), it says so.  torch.profiler traces
    are not used here: on the card they lost kernel records of repeated
    calls."""
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_cycles_per_ms(torch)
                          * (1.5 * reps * host_ms + 0.5)))
    start.record()
    for _ in range(reps):
        res = fn()
    ahead = not start.query()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    if not ahead:
        log(f"[timer] {ms:.4f} ms a call includes host gaps (the host took "
            f"{host_ms:.3f} ms to enqueue one)")
    return res, ms


def mismatches(torch, pairs):
    """(mismatching elements, elements, max |a - b|) over int tensor pairs."""
    bad = total = 0
    worst = 0.0
    for a, b in pairs:
        a64, b64 = a.to(torch.int64), b.to(torch.int64)
        diff = a64 != b64
        bad += int(diff.sum())
        total += a.numel()
        if diff.any():
            worst = max(worst, float((a64 - b64).abs().max()))
    return bad, total, worst


def check_ints(torch, name, pairs):
    """(max |d|, share of mismatching elements) of int tensor pairs; fails
    above 1e-4 of the elements (float-boundary flips of a minQuadRect or
    span test)."""
    bad, total, worst = mismatches(torch, pairs)
    if bad > 1e-4 * total:
        raise RuntimeError(f"{name}: {bad} of {total} outputs differ")
    return worst, bad / total


def stage_of(kernel: str) -> str:
    """The frame stage of a device kernel, by name (STAGE_KERNELS)."""
    for stage, keys in STAGE_KERNELS:
        if any(k in kernel for k in keys):
            return stage
    return "torch ops"


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_label(mangled: str) -> str:
    """``blend_kernel<2>`` from a mangled name such as
    ``_ZN12_GLOBAL__N_112blend_kernelILi2EEEvPKj...`` (the length-prefixed
    names read in order until one ends in ``_kernel``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while True:
        d = re.match(r"\d+", mangled[pos:])
        if d is None:
            return mangled[:40]
        pos += d.end()
        name = mangled[pos:pos + int(d.group())]
        pos += len(name)
        if name.endswith("_kernel"):
            t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
            if t is None:
                return name
            args = [("true" if v == "1" else "false") if k == "b" else v
                    for k, v in re.findall(r"L([ib])(\d+)E", t.group(1))]
            return f"{name}<{','.join(args)}>"


def ptxas_report(text: str) -> dict:
    """Registers, shared memory and spill bytes of each kernel from an
    ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = kernel_label(m.group(1))
            out.setdefault(name, {})
        elif name and "spill" in line:
            st = re.search(r"(\d+) bytes spill stores", line)
            ld = re.search(r"(\d+) bytes spill loads", line)
            out[name]["spill_bytes"] = int(st.group(1)) + int(ld.group(1))
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["registers"] = int(regs.group(1))
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def sass_loop_counts(sass: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing, the static instruction
    counts of the innermost loop that holds an exp (MUFU.EX2): the blend's
    composite loop, one record of every eye an iteration.  Loops are read
    from conditional backward branches (the unconditional ones return from
    the compiler's divergent-vote fallback)."""
    res = {}
    for chunk in sass.split("Function : ")[1:]:
        name = kernel_label(chunk.split()[0])
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk):
            raw = m.group(2).strip()
            text = re.sub(r"^@!?U?P\w+\s+", "", raw)
            ins.append((int(m.group(1), 16), text, raw != text))
        ins_ops = [(a, x) for a, x, _ in ins]
        loops = []
        for addr, text, predicated in ins:
            t = re.match(r"BRA(?:\.\S+)?\s.*?0x([0-9a-f]+)", text)
            if t and predicated and int(t.group(1), 16) <= addr:
                body = [x for a, x in ins_ops if int(t.group(1), 16) <= a <= addr]
                if any(x.startswith("MUFU.EX2") for x in body):
                    loops.append(body)
        if not loops:
            continue
        body = min(loops, key=len)
        ops = [x.split()[0] for x in body]
        count = lambda pre: sum(o.startswith(pre) for o in ops)  # noqa: E731
        res[name] = dict(instructions=len(ops), LDS=count("LDS"),
                         LDS_128=count("LDS.128"), FMUL=count("FMUL"),
                         FADD=count("FADD"), FFMA=count("FFMA"),
                         MUFU=count("MUFU"), MUFU_EX2=count("MUFU.EX2"),
                         VOTE=count("VOTE"))
    return res


def phase_build(native):
    t0 = time.perf_counter()
    out = native.build_all()
    seconds = time.perf_counter() - t0
    log(f"[build] kernels built in {seconds:.1f} s into {out}")
    log(json.dumps({"build_seconds": seconds}))
    for name in native.SOURCES:
        report = ptxas_report((out / f"{name}.log").read_text())
        log(f"[build] {name}.cu ptxas: " + json.dumps(report))
        for label, r in report.items():
            if label.startswith(SPILL_CHECKED) and r.get("spill_bytes", 0) > 0:
                raise RuntimeError(f"{label} spills registers: {r}")
    cuobjdump = Path(native._nvcc()).parent / "cuobjdump"
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(out / "libblend.so")],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        log("[build] blend inner loop SASS (static counts): "
            + json.dumps(sass_loop_counts(sass)))
    else:
        log("[build] no cuobjdump beside nvcc: SASS counts not printed")
    import torch

    expf_zero_check(torch)
    log("[build] blend launches (threads, CTAs a tile, CTAs and warps an SM, "
        "registers): " + json.dumps({f"{f}.{t[0]}x{t[1]}": blend_occupancy(
            f, t) for f, t in BLEND_AB}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def timed_frames(torch, render, n_lock: int = 2, n_warm: int = 3,
                 n_timed: int = 10):
    """(last output, stats): ``n_lock`` capacity lock-in and ``n_warm``
    warm-up frames, then ``n_timed`` frames timed with CUDA events."""
    out = None
    for _ in range(n_lock + n_warm):
        out = render()
    torch.cuda.synchronize()
    times = []
    t0 = time.perf_counter()
    for _ in range(n_timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = render()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    ms = [s.elapsed_time(e) for s, e in times]
    hd = out.header
    stats = dict(avg=sum(ms) / len(ms), min=min(ms), max=max(ms),
                 wall_avg=wall_ms, visible=int(hd.visible_count),
                 total_instances=int(hd.total_instances),
                 slot_total=int(hd.slot_total), overflow=int(hd.overflow))
    if hd.row_total is not None:
        stats["row_total"] = int(hd.row_total)
    return out, stats


def frame_split(torch, render, frames: int = 5) -> dict:
    """Host and device time of a frame, apart.  ``host_ms``: the host's time
    to enqueue one frame while a sleep kernel holds the device, so that it
    never waits on the device; ``device_ms``: the device time per frame of
    those frames, which run back to back behind the sleep, so that no host
    gap enters it.  Frames timed back to back (``timed_frames``) take about
    the larger of the two: the frame is host-bound where ``host_ms`` is.
    ``host_ahead`` is false where the host waited on the device (a host
    read, or a launch queue filled by the frames queued behind the sleep),
    and the split is then not valid."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render()
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_cycles_per_ms(torch)
                          * (2.0 * frames * one_ms + 1.0)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(frames):
        render()
    host_ms = (time.perf_counter() - t0) * 1e3 / frames
    ahead = not start.query()
    end.record()
    end.synchronize()
    return dict(host_ms=host_ms, device_ms=start.elapsed_time(end) / frames,
                host_ahead=ahead)


def host_syncs(torch, render, label: str) -> list:
    """The host synchronisations of one frame: ``render`` once under
    ``torch.cuda.set_sync_debug_mode("warn")``, each warning's message with
    the innermost frames of this repository's code that led to it."""
    import traceback
    import warnings

    sites = []

    def keep(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "gsm_renderer_tpu_torch" in f.filename]
        sites.append(dict(message=str(message)[:160],
                          at=[f"{Path(f.filename).name}:{f.lineno} {f.name}"
                              for f in frames[-4:]]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            render()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the warning that the mode itself is a prototype is no sync
    sites = [x for x in sites if "prototype feature" not in x["message"]]
    log(f"[{label}] host syncs in one frame (sync debug mode): {len(sites)} "
        + json.dumps(sites))
    return sites


def host_waits(torch, render, label: str, hold_ms: float = 50.0,
               min_ms: float = 1.0) -> list:
    """Where one frame's host waits on the device, found by the clock: a
    sleep kernel holds the device for ``hold_ms``, ``render`` runs once
    under ``sys.setprofile``, and every call made from this repository's
    package (Python functions and the C functions they call) that took
    ``min_ms`` or more on the host is kept, innermost first.  A frame that
    never waits keeps none; one that waits keeps the chain of calls down to
    the one that blocked.  Catches what the sync debug mode does not see."""
    torch.cuda.synchronize()
    stack, slow = [], []

    def prof(frame, event, arg):
        if event in ("call", "c_call"):
            stack.append(time.perf_counter())
        elif event in ("return", "c_return", "c_exception") and stack:
            ms = (time.perf_counter() - stack.pop()) * 1e3
            where = frame.f_code.co_filename
            if ms >= min_ms and "gsm_renderer_tpu_torch" in where:
                what = (getattr(arg, "__qualname__", repr(arg))
                        if event.startswith("c_") else frame.f_code.co_name)
                slow.append(dict(ms=ms, depth=len(stack), call=str(what)[:60],
                                 at=f"{Path(where).name}:{frame.f_lineno}"))

    torch.cuda._sleep(int(sleep_cycles_per_ms(torch) * hold_ms))
    sys.setprofile(prof)
    try:
        render()
    finally:
        sys.setprofile(None)
    torch.cuda.synchronize()
    slow.sort(key=lambda x: -x["depth"])
    log(f"[{label}] host calls of {min_ms} ms or more in one frame with the "
        f"device held {hold_ms} ms: " + json.dumps(slow[:12]))
    return slow[:12]


def check_frame(torch, out, label: str, halves: int = 1):
    """Overflow 0, finite colour and depth, non-black pixels (in each half
    of a side-by-side frame)."""
    if int(out.header.overflow) != 0:
        raise RuntimeError(f"{label}: frame overflowed")
    if not torch.isfinite(out.color).all() or not torch.isfinite(out.depth).all():
        raise RuntimeError(f"{label}: frame is not finite")
    w = out.color.shape[1] // halves
    for k in range(halves):
        half = out.color[:, k * w:(k + 1) * w, :3]
        nonblack = float((half.amax(-1) > 0.02).float().mean())
        log(f"[{label}] non-black fraction (part {k}) {nonblack:.4f}")
        if nonblack <= 0.0:
            raise RuntimeError(f"{label}: frame (part {k}) is black")


def drive_path(torch, kernels, names, label, render):
    """Counts to 0, the path's frames, counts read: (out, stats, launches).
    Fails if a kernel of the path was not launched."""
    for k in kernels:
        k.launches = 0
    out, stats = render()
    launches = {k.name: k.launches for k in kernels}
    for name in names:
        if launches[name] <= 0:
            raise RuntimeError(f"{label}: kernel {name} was not launched")
    log(f"[{label}] launches " + json.dumps(launches))
    return out, stats, launches


def phase_headline(torch, T, kernels, n: int = 1_000_000):
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

    ds = generate_visible_gaussians(n, sh_degree=3, seed=7,
                                    scale_range=(0.002, 0.012))
    cam = T.make_camera(W, H, far=50.0)
    cfg = T.RendererConfig(sh_degree=3, precision=T.Precision.FLOAT32,
                           max_width=W, max_height=H)
    gi = ds.to_input(T.Precision.FLOAT32)
    r = T.DepthFirstRenderer(cfg)
    out, stats, launches = drive_path(
        torch, kernels, MONO_ROWS_PATH, "headline",
        lambda: timed_frames(torch, lambda: r.render(gi, cam, W, H)))
    capacity = r._cap_state[(r._mono_key, n)]["cap"]
    row_capacity = r._cap_state[("rows", r._mono_key, n)]["cap"]
    if row_capacity <= 0:
        raise RuntimeError("headline: the row decomposition was not on")
    stats.update(capacity=capacity, row_capacity=row_capacity,
                 msplats_per_s=n / stats["avg"] / 1e3,
                 split=frame_split(torch, lambda: r.render(gi, cam, W, H)))
    check_frame(torch, out, "headline")

    r_off = T.DepthFirstRenderer(dataclasses.replace(cfg, row_expand=False))
    off, off_stats, off_launches = drive_path(
        torch, kernels, MONO_RECTS_PATH, "headline rows_off",
        lambda: timed_frames(torch, lambda: r_off.render(gi, cam, W, H),
                             n_warm=1, n_timed=5))
    off_capacity = r_off._cap_state[(r_off._mono_key, n)]["cap"]
    stats["rows_off"] = dict(
        avg=off_stats["avg"], slot_total=off_stats["slot_total"],
        capacity=off_capacity,
        split=frame_split(torch, lambda: r_off.render(gi, cam, W, H)))
    log("[headline] " + json.dumps({"headline_frame_ms": stats}))
    if not (torch.equal(out.color, off.color) and torch.equal(out.depth, off.depth)):
        raise RuntimeError("headline: rows-on frame differs from rows-off")
    log("[headline] rows-on colour and depth bit-equal to rows-off")
    return dict(r=r, gi=gi, cam=cam, cfg=cfg, out=out, n=n, w=W, h=H,
                capacity=capacity, row_capacity=row_capacity,
                launches=launches, off_capacity=off_capacity,
                off_launches=off_launches, stats=stats)


def trace_frames(torch, render, label: str, frames: int = 10):
    """Device busy share and kernel time by name over ``frames`` frames,
    from a torch.profiler trace (profiler on: the host is slower than in
    the timed frames, so this idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = device_kernel_stats(prof)
    rows = sorted(((ms / frames, name[:60], count) for name, (ms, count) in
                   stats.items()), reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    stages = {}
    for name, (ms, _count) in stats.items():
        stages[stage_of(name)] = stages.get(stage_of(name), 0.0) + ms / frames
    if busy == 0.0:
        log(f"[{label}] the profiler recorded no device time: idle share "
            "not measured")
        return None
    res = {"frame_wall_ms": wall_ms / frames, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall_ms / frames),
           "launches_per_frame": sum(c for _ms, c in stats.values()) / frames,
           "stages": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
           "old_scan_launches": sum(
               count for name, (_ms, count) in stats.items()
               if any(k in name for k in OLD_SCAN_KERNELS)),
           "kernels": [dict(ms=ms, name=name, launches=count)
                       for ms, name, count in rows[:16]],
           # kernels a frame launches a fixed number of times, seen a number
           # of times that is not a multiple of the frames: lost records
           "uneven_launches": [name for _, name, count in rows
                               if count % frames]}
    log(f"[{label}] " + json.dumps(res))
    return res


#: off under --kernels, which may time another tree's package
REQUIRE_ONE_PASS_SCAN = True


def require_one_pass_scan(trace, label: str) -> None:
    """Fails if a traced frame launched a separate scan kernel."""
    if (REQUIRE_ONE_PASS_SCAN and trace is not None
            and trace["old_scan_launches"]):
        raise RuntimeError(f"{label}: {trace['old_scan_launches']} launches of "
                           f"{OLD_SCAN_KERNELS} in the traced frames")


def realistic_scene(T, n: int = 1_000_000, ds=None):
    """(input, camera) of the heavy-tailed scene the row decomposition is
    for (``ds``, or ``generate_realistic_gaussians(n, sh_degree=3)``):
    recentred on its bounding box, the camera just before the nearest
    splats looking +z, far 80."""
    import numpy as np
    from gsm_renderer_tpu_torch.io.scene import generate_realistic_gaussians

    if ds is None:
        ds = generate_realistic_gaussians(n, sh_degree=3)
    center = 0.5 * (ds.positions.min(0) + ds.positions.max(0))
    if np.linalg.norm(center) > 1e-6:
        ds.positions = (ds.positions - center).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -(ds.positions[:, 2].min() - 1.0)
    cam = T.make_camera(W, H, view_matrix=view, far=80.0)
    return ds.to_input(T.Precision.FLOAT32), cam


def numpy_decode(fn):
    """``fn()`` with the native library hidden from the loaders: their
    NumPy decode."""
    from gsm_renderer_tpu_torch import native

    get_lib = native.get_lib
    native.get_lib = lambda: None
    try:
        return fn()
    finally:
        native.get_lib = get_lib


#: tests/test_io.py's bounds of the native decode against the NumPy one
#: (atol, rtol) per array
DECODE_TOLS = dict(positions=(1e-6, 0.0), scales=(0.0, 1e-6),
                   rotations=(1e-6, 0.0), opacities=(1e-7, 0.0),
                   harmonics=(1e-6, 0.0))
#: float32 ulps by which an element may also differ: the two decoders take
#: exp (scales) and the logistic (opacities) from different libraries
#: (glibc's expf, NumPy's float32 exp), which differ by up to 2 ulps; at
#: opacities in [0.5, 1) 2 ulps exceed the 1e-7 above (11,050 of the
#: realistic scene's 1M opacities, on a CPU host)
DECODE_ULPS = 2


def decoders_agree(a, b, label: str) -> dict:
    """Max |d| and max float32 ulps of each array of two decodes of one
    file; fails where an element is beyond both DECODE_TOLS and
    DECODE_ULPS."""
    import numpy as np

    out = {}
    for name, (atol, rtol) in DECODE_TOLS.items():
        x, y = getattr(a, name), getattr(b, name)
        if x.shape != y.shape:
            raise RuntimeError(f"{label}: native and NumPy {name} shapes differ")
        d = np.abs(x.astype(np.float64) - y)
        ulps = d / np.spacing(np.maximum(np.abs(x), np.abs(y)))
        ok = (d <= atol + rtol * np.abs(y)) | (ulps <= DECODE_ULPS)
        if not ok.all():
            raise RuntimeError(f"{label}: native and NumPy {name} differ at "
                               f"{int((~ok).sum())} elements")
        out[name] = dict(max_abs=float(d.max()) if d.size else 0.0,
                         max_ulps=float(ulps.max()) if d.size else 0.0)
    return out


def ply_round_trip(ds, label: str):
    """Write ``ds`` as a standard PLY to a temporary file, load it with the
    native decoder (which must build and load) and with the NumPy one,
    hold them together (DECODE_TOLS) and delete the file.  Returns (the
    native load, a dict of the file size and both load times)."""
    import os
    import tempfile
    from gsm_renderer_tpu_torch import native
    from gsm_renderer_tpu_torch.io import ply

    if not native.native_available():
        raise RuntimeError(f"{label}: the native library did not build or load")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.ply")
        t0 = time.perf_counter()
        ply.write_ply(ds, path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = ply.load_ply(path)
        native_s = time.perf_counter() - t0
        if ply.last_decoder() != "native":
            raise RuntimeError(f"{label}: load_ply did not decode natively")
        t0 = time.perf_counter()
        slow = numpy_decode(lambda: ply.load_ply(path))
        numpy_s = time.perf_counter() - t0
        if ply.last_decoder() != "numpy":
            raise RuntimeError(f"{label}: the NumPy decode did not run")
        info = dict(file_bytes=os.path.getsize(path), write_s=write_s,
                    native_load_s=native_s, numpy_load_s=numpy_s,
                    decoder="native", gaussians=loaded.count,
                    native_vs_numpy_max_abs=decoders_agree(loaded, slow, label))
    log(f"[{label}] " + json.dumps({"ply_round_trip": info}))
    return loaded, info


def phase_realistic(torch, T, n: int = 1_000_000):
    """The heavy-tailed scene through a PLY file (written, loaded with the
    native decoder and checked against the NumPy decode), rows on and
    off."""
    from gsm_renderer_tpu_torch.io.scene import generate_realistic_gaussians

    loaded, ply_info = ply_round_trip(
        generate_realistic_gaussians(n, sh_degree=3), "realistic")
    gi, cam = realistic_scene(T, n, loaded)
    outs, res = {}, {"ply": ply_info}
    for label, rows in (("rows_on", True), ("rows_off", False)):
        r = T.DepthFirstRenderer(T.RendererConfig(
            sh_degree=3, precision=T.Precision.FLOAT32, max_width=W,
            max_height=H, row_expand=rows))
        outs[label], res[label] = timed_frames(
            torch, lambda r=r: r.render(gi, cam, W, H))
        res[label]["split"] = frame_split(torch,
                                          lambda r=r: r.render(gi, cam, W, H))
        require_one_pass_scan(trace_frames(
            torch, lambda r=r: r.render(gi, cam, W, H),
            f"realistic {label} trace", frames=5), f"realistic {label}")
        check_frame(torch, outs[label], f"realistic {label}")
    log("[realistic] " + json.dumps({"realistic_frame_ms": res}))
    on, off = outs["rows_on"], outs["rows_off"]
    if not (torch.equal(on.color, off.color) and torch.equal(on.depth, off.depth)):
        raise RuntimeError("realistic: rows-on frame differs from rows-off")
    if not res["rows_on"]["slot_total"] < res["rows_off"]["slot_total"]:
        raise RuntimeError("realistic: rows did not shrink the slot total")
    log("[realistic] rows-on colour and depth bit-equal to rows-off")
    return dict(res=res, gi=gi, cam=cam)


def phase_scene_files(torch, T, kernels, hl):
    """Phase 3f: one headline frame from each other scene file -- the
    headline scene written as a compressed PLY and as a .splat (DC colour:
    SH degree 0) and loaded back (the compressed one with the native
    decoder), and the headline camera written to an INRIA cameras.json and
    read back by ``load_cameras_json`` -- each through
    ``DepthFirstRenderer.render`` with launch counts of its own: overflow
    0, finite, non-black.  The PLY loaders recentre the scene on its
    bounding box: their camera backs off by that centre."""
    import numpy as np
    from gsm_renderer_tpu_torch.io import ply, poses, splat
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

    ds = generate_visible_gaussians(hl["n"], sh_degree=3, seed=7,
                                    scale_range=(0.002, 0.012))
    cam = hl["cam"]
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = 0.5 * (ds.positions.min(0) + ds.positions.max(0))
    recentred_cam = T.make_camera(W, H, view_matrix=view, far=cam.far_plane)
    res, files = {}, {}

    t0 = time.perf_counter()
    data = ply.write_compressed_ply(ds)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ply.load_ply(data)
    load_s = time.perf_counter() - t0
    if ply.last_decoder() != "native":
        raise RuntimeError("compressed PLY: load_ply did not decode natively")
    files["compressed_ply"] = (loaded.to_input(T.Precision.FLOAT32),
                               recentred_cam)
    res["compressed_ply"] = dict(file_bytes=len(data), write_s=write_s,
                                 load_s=load_s, decoder="native")

    t0 = time.perf_counter()
    data = splat.write_splat(ds)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = splat.load_splat(data)
    res["splat"] = dict(file_bytes=len(data), write_s=write_s,
                        load_s=time.perf_counter() - t0)
    files["splat"] = (loaded.to_input(T.Precision.FLOAT32), cam)

    proj = cam.projection_matrix
    entry = dict(id=0, img_name="headline", width=W, height=H,
                 position=[float(x) for x in cam.position],
                 rotation=np.eye(3).tolist(),
                 fx=float(proj[0, 0]) * W / 2, fy=float(proj[1, 1]) * H / 2)
    (pose_cam, pw, ph, _name), = poses.load_cameras_json(
        json.dumps([entry]), near=cam.near_plane, far=cam.far_plane)
    if (pw, ph) != (W, H):
        raise RuntimeError(f"cameras.json: read back {pw}x{ph}")
    files["cameras_json"] = (hl["gi"], pose_cam)
    res["cameras_json"] = dict(
        projection_max_abs=float(np.abs(pose_cam.projection_matrix
                                        - proj).max()))

    for label, (gi, c) in files.items():
        r = T.DepthFirstRenderer(hl["cfg"])
        out, stats, launches = drive_path(
            torch, kernels, MONO_ROWS_PATH, f"scene file {label}",
            lambda r=r, gi=gi, c=c: timed_frames(
                torch, lambda: r.render(gi, c, W, H), n_warm=1, n_timed=3))
        check_frame(torch, out, f"scene file {label}")
        res[label].update(
            avg=stats["avg"], slot_total=stats["slot_total"],
            visible=stats["visible"], launches=launches,
            headline_mean_abs=float((out.color - hl["out"].color).abs().mean()),
            equal_to_headline=bool(torch.equal(out.color, hl["out"].color)))
    log("[scene files] " + json.dumps({"scene_file_frames": res}))
    return res


def phase_profile(torch, hl):
    """Phase 3p: ``profile_depth_first_stages`` on the headline scene (its
    chain is the rows-off frame's, at that frame's capacity), beside the
    same run's rows-off queued device time (``frame_split``).  Requires
    every stage > 0 and the total within 15% of that time."""
    from gsm_renderer_tpu_torch.profiling import (STAGES,
                                                  profile_depth_first_stages)

    cfg = hl["cfg"]
    split = profile_depth_first_stages(
        hl["gi"], hl["cam"], W, H, sh_degree=3, capacity=hl["off_capacity"],
        alpha_threshold=cfg.alpha_threshold,
        total_ink_threshold=cfg.total_ink_threshold)
    queued = hl["stats"]["rows_off"]["split"]
    log("[profile] " + json.dumps({
        "profile_depth_first_stages_ms": split,
        "rows_off_queued_device_ms": queued["device_ms"],
        "rows_off_host_ahead": queued["host_ahead"],
        "total_over_queued": split["total"] / queued["device_ms"]}))
    bad = [k for k in STAGES if not split[k] > 0.0]
    if bad:
        raise RuntimeError(f"profile: stages {bad} took no time")
    if not queued["host_ahead"]:
        raise RuntimeError("profile: the rows-off split is not valid (the host "
                           "waited on the device)")
    if abs(split["total"] - queued["device_ms"]) > 0.15 * queued["device_ms"]:
        raise RuntimeError(f"profile: total {split['total']:.4f} ms is not "
                           f"within 15% of the rows-off frame's queued device "
                           f"time {queued['device_ms']:.4f} ms")
    return split


def d16_tile_counts(torch, T, gi, cam, cfg, tile_w: int, capacity: int):
    """(starts, counts) of the 16-bit-key chain's tiles for a frame, on the
    device (the unclamped counts a Local frame clamps)."""
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.pipelines import common as PC

    tiles_x, tiles_y = -(-W // tile_w), -(-H // 16)
    srt, _packed, _total, _overflow = PC.d16_packed_sorted(
        gi, cam.view_matrix, cam.projection_matrix, cam.position,
        cached_projection_inputs(gi, 3),
        key_plan=PC.d16_key_plan(tiles_x * tiles_y, gi.count), width=W,
        height=H, capacity=capacity, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_w, tile_h=16, sh_degree=3,
        alpha_threshold=cfg.alpha_threshold,
        total_ink_threshold=cfg.total_ink_threshold,
        near_plane=cam.near_plane, far_plane=cam.far_plane,
        input_is_srgb=False)
    return srt.starts, srt.counts


def tile_pixels(torch, tiles, tiles_x: int, tile_w: int, device):
    """(H, W) bool image of the pixels of ``tiles`` (tile_w x 16 tiles)."""
    on = torch.zeros(-(-H // 16) * 16, tiles_x * tile_w, dtype=torch.bool,
                     device=device)
    for t in tiles.tolist():
        ty, tx = divmod(int(t), tiles_x)
        on[ty * 16:(ty + 1) * 16, tx * tile_w:(tx + 1) * tile_w] = True
    return on[:H, :W]


def phase_d16(torch, T, kernels, hl, real=None):
    """The 16-bit-depth-key renderers on the headline scene: Global (32x16
    tiles), Local (16x16, per-tile clamp, first-hit depth) and DepthFirst
    with depth_sort_key_precision=BITS16 under both tile-id precisions,
    each with its own launch counts, frame times, split and trace.  Then
    the cross-frame checks, and Local on the realistic scene (``real``)."""
    gi, cam, n, cfg = hl["gi"], hl["cam"], hl["n"], hl["cfg"]
    bits16 = T.DepthSortKeyPrecision.BITS16
    paths = {
        "global": (T.GlobalRenderer, {}),
        "local": (T.LocalRenderer, {}),
        "df16_tile16": (T.DepthFirstRenderer,
                        dict(depth_sort_key_precision=bits16)),
        "df16_tile32": (T.DepthFirstRenderer,
                        dict(depth_sort_key_precision=bits16,
                             tile_id_precision=T.TileIdPrecision.BITS32)),
    }
    res, frames = {}, {}
    for label, (cls, opt) in paths.items():
        r = cls(dataclasses.replace(cfg, **opt))
        render = lambda r=r: r.render(gi, cam, W, H)
        out, stats, launches = drive_path(
            torch, kernels, D16_PATH, label,
            lambda render=render: timed_frames(torch, render))
        check_frame(torch, out, label)
        stats.update(capacity=r._cap_state[(r._mono_key, n)]["cap"],
                     split=frame_split(torch, render))
        trace = trace_frames(torch, render, f"{label} trace", frames=5)
        require_one_pass_scan(trace, label)
        stats["trace"] = trace
        res[label] = dict(r=r, out=out, stats=stats, launches=launches)
        frames[label] = stats
    log("[d16] " + json.dumps({"d16_frame_ms": frames}))

    a, b = res["df16_tile16"]["out"], res["df16_tile32"]["out"]
    if not (torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)):
        raise RuntimeError("d16: the two DepthFirst BITS16 frames differ")
    log("[d16] DepthFirst BITS16 frames bit-equal under tile ids 16 and 32")
    loc = res["local"]
    starts, counts = d16_tile_counts(torch, T, gi, cam, cfg, 16,
                                     loc["stats"]["capacity"])
    clamped = torch.nonzero(counts > T.config.LOCAL_MAX_PER_TILE).flatten()
    keep = ~tile_pixels(torch, clamped, -(-W // 16), 16, gi.positions.device)
    if not torch.equal(loc["out"].color[keep], a.color[keep]):
        raise RuntimeError("d16: Local colour differs from DepthFirst BITS16 "
                           "on unclamped tiles")
    dg = float((res["global"]["out"].color[..., :3]
                - hl["out"].color[..., :3]).abs().mean())
    log("[d16] " + json.dumps({
        "local_clamped_tiles": int(clamped.numel()),
        "max_tile_count": int(counts.max()),
        "local_equals_df16_on_unclamped_tiles": True,
        "global_vs_depth_first_mean_abs_diff": dg}))
    if not dg < 0.01:
        raise RuntimeError(f"d16: Global vs DepthFirst mean |d| {dg}")

    if real is not None:
        r = T.LocalRenderer(cfg)
        render = lambda: r.render(real["gi"], real["cam"], W, H)
        out, stats = timed_frames(torch, render, n_timed=5)
        check_frame(torch, out, "realistic local")
        _s, rc = d16_tile_counts(torch, T, real["gi"], real["cam"], cfg, 16,
                                 r._cap_state[(r._mono_key, n)]["cap"])
        stats["clamped_tiles"] = int((rc > T.config.LOCAL_MAX_PER_TILE).sum())
        stats["max_tile_count"] = int(rc.max())
        log("[d16] " + json.dumps({"realistic_local_frame_ms": stats}))
    return res


def phase_hardware(torch, T, kernels, hl, st, fv):
    """Phase 4h: the HardwareRenderer on the headline scene -- the mono
    frame (full rects: prep and the expand in mode "none", the blend with
    the r^2 <= 9 cutoff and normalized depth) with its own launch counts,
    frame times, split and trace; the INSTANCED and back_to_front frames
    bit-equal to it, its colour within a mean |d| of 0.01 of the DepthFirst
    headline's; then the stereo and foveated frames, whose colour must be
    the DepthFirst frames' (``st``, ``fv``) and whose depth their depth
    over max(alpha, 1e-6), bit for bit."""
    gi, cam, n, cfg = hl["gi"], hl["cam"], hl["n"], hl["cfg"]
    r = T.HardwareRenderer(cfg)
    render = lambda: r.render(gi, cam, W, H)
    out, stats, launches = drive_path(
        torch, kernels, HARDWARE_PATH, "hardware",
        lambda: timed_frames(torch, render))
    check_frame(torch, out, "hardware")
    if out.header.row_total is not None:
        raise RuntimeError("hardware: the header carries a row total")
    capacity = r._cap_state[(r._mono_key, n)]["cap"]
    stats.update(capacity=capacity, split=frame_split(torch, render))
    trace = trace_frames(torch, render, "hardware trace", frames=5)
    require_one_pass_scan(trace, "hardware")
    stats["trace"] = trace
    for label, opt in (
            ("INSTANCED", dict(hardware_backend=T.HardwareBackend.INSTANCED)),
            ("back_to_front", dict(back_to_front=True))):
        o = T.HardwareRenderer(dataclasses.replace(cfg, **opt)).render(
            gi, cam, W, H)
        if not (torch.equal(o.color, out.color) and torch.equal(o.depth, out.depth)):
            raise RuntimeError(f"hardware: the {label} frame differs")
    dh = float((out.color[..., :3] - hl["out"].color[..., :3]).abs().mean())
    log("[hardware] " + json.dumps({
        "hardware_frame_ms": stats, "instanced_and_back_to_front_bit_equal":
        True, "hardware_vs_depth_first_mean_abs_diff": dh}))
    if not dh < 0.01:
        raise RuntimeError(f"hardware: vs DepthFirst mean |d| {dh}")

    res = dict(r=r, out=out, capacity=capacity, launches=launches,
               stats=stats)
    for label, path, df, fn in (
            ("stereo", STEREO_PATH, st["out"],
             lambda: r.render_stereo(gi, st["stereo"], W, H)),
            ("foveated", FOVEATED_PATH, fv["out"],
             lambda: r.render_stereo_foveated(gi, st["stereo"], fv["target"]))):
        o, s2, l2 = drive_path(
            torch, kernels, path, f"hardware {label}",
            lambda fn=fn: timed_frames(torch, fn, n_warm=1, n_timed=5))
        check_frame(torch, o, f"hardware {label}", halves=2)
        if not torch.equal(o.color, df.color):
            raise RuntimeError(f"hardware {label}: colour differs from the "
                               "DepthFirst frame's")
        if not torch.equal(o.depth, df.depth / df.color[..., 3].clamp_min(1e-6)):
            raise RuntimeError(f"hardware {label}: depth is not the DepthFirst "
                               "depth over max(alpha, 1e-6)")
        s2.update(split=frame_split(torch, fn, frames=2),
                  trace=trace_frames(torch, fn, f"hardware {label} trace",
                                     frames=5))
        log(f"[hardware] {label}: colour bit-equal to DepthFirst, depth its "
            "depth over max(alpha, 1e-6); " + json.dumps(
                {f"hardware_{label}_frame_ms": s2}))
        res[f"{label}_out"], res[f"{label}_launches"] = o, l2
    return res


def phase_stereo(torch, T, kernels, hl):
    r = T.DepthFirstRenderer(hl["cfg"])
    stereo = T.make_side_by_side_stereo(hl["cam"])
    gi, n = hl["gi"], hl["n"]
    out, stats, launches = drive_path(
        torch, kernels, STEREO_PATH, "stereo",
        lambda: timed_frames(torch, lambda: r.render_stereo(gi, stereo, W, H)))
    capacity = r._cap_state[(r._stereo_key, n)]["cap"]
    stats.update(capacity=capacity, shape=list(out.color.shape),
                 split=frame_split(torch,
                                   lambda: r.render_stereo(gi, stereo, W, H)))
    log("[stereo] " + json.dumps({"stereo_frame_ms": stats}))
    if tuple(out.color.shape) != (H, 2 * W, 4):
        raise RuntimeError(f"stereo: frame shape {tuple(out.color.shape)}")
    check_frame(torch, out, "stereo", halves=2)
    stats["host_waits"] = host_waits(
        torch, lambda: r.render_stereo(gi, stereo, W, H), "stereo")
    trace = trace_frames(torch, lambda: r.render_stereo(gi, stereo, W, H),
                         "stereo trace", frames=5)
    require_one_pass_scan(trace, "stereo")
    return dict(r=r, stereo=stereo, out=out, capacity=capacity,
                launches=launches, stats=stats, trace=trace)


def phase_foveated(torch, T, kernels, hl, st):
    """Foveated stereo: the headline scene and the stereo rig into the
    physical target of the JAX bench's foveated row, then one timed line at
    the aggressive rate map."""
    r = T.DepthFirstRenderer(hl["cfg"])
    target = T.make_rate_maps(W, H, min_rate=FOV_MIN_RATE, radius=FOV_RADIUS)
    gi, n, stereo = hl["gi"], hl["n"], st["stereo"]
    render = lambda: r.render_stereo_foveated(gi, stereo, target)
    out, stats, launches = drive_path(
        torch, kernels, FOVEATED_PATH, "foveated",
        lambda: timed_frames(torch, render))
    capacity = r._cap_state[(r._stereo_key + "_fov", n)]["cap"]
    shape = (target.render_height, 2 * target.render_width, 4)
    # five frames of about 200 launches each fill the launch queue
    # behind the sleep kernel, and the host then waits for room: two frames
    # fit
    stats.update(capacity=capacity, shape=list(out.color.shape),
                 min_rate=FOV_MIN_RATE, split=frame_split(torch, render),
                 split_2=frame_split(torch, render, frames=2))
    if tuple(out.color.shape) != shape:
        raise RuntimeError(f"foveated: frame shape {tuple(out.color.shape)}, "
                           f"expected {shape}")
    check_frame(torch, out, "foveated", halves=2)
    stats["host_syncs"] = host_syncs(torch, render, "foveated")
    stats["host_waits"] = host_waits(torch, render, "foveated")
    trace = trace_frames(torch, render, "foveated trace", frames=5)
    require_one_pass_scan(trace, "foveated")

    low = T.make_rate_maps(W, H, min_rate=FOV_MIN_RATE_LOW, radius=FOV_RADIUS)
    r_low = T.DepthFirstRenderer(hl["cfg"])
    out_low, low_stats = timed_frames(
        torch, lambda: r_low.render_stereo_foveated(gi, stereo, low), n_timed=5)
    low_stats.update(min_rate=FOV_MIN_RATE_LOW,
                     shape=list(out_low.color.shape))
    check_frame(torch, out_low, "foveated low rate", halves=2)
    log("[foveated] " + json.dumps({
        "foveated_frame_ms": stats, "stereo_frame_ms": st["stats"],
        "foveated_low_rate_frame_ms": low_stats}))

    def split(tr):
        return None if tr is None else {
            k["name"]: k["ms"] for k in tr["kernels"]}
    log("[foveated] " + json.dumps({"device_split_ms": {
        "foveated": split(trace), "stereo": split(st["trace"])},
        "device_busy_ms": {
            "foveated": None if trace is None else trace["device_busy_ms"],
            "stereo": None if st["trace"] is None
            else st["trace"]["device_busy_ms"]}}))
    return dict(r=r, target=target, out=out, capacity=capacity,
                launches=launches, stats=stats)


def composited_ranks(torch, starts, processed):
    """(tile, sorted rank) of every record the blend composited: the first
    ``processed[t]`` ranks of tile t's span."""
    tile = torch.repeat_interleave(
        torch.arange(starts.shape[0], device=starts.device), processed)
    rank = (starts.to(torch.int64)[tile]
            + torch.arange(tile.numel(), device=starts.device)
            - torch.repeat_interleave(
                torch.cumsum(processed, 0) - processed, processed))
    return tile, rank


def blend_bytes(torch, KB, ent, starts, processed, n_words, out_pixels):
    """Bytes the blend must move on this run's data: the key (8 B) of each
    record composited, the ``n_words`` distinct words of each entry
    composited, the tile spans, and the colour (16 B) and depth (4 B) of
    each of the ``out_pixels`` pixels (all eyes)."""
    sorted_key, _words, idx_bits = ent
    _tile, rank = composited_ranks(torch, starts, processed)
    entries = int(torch.unique(KB.entry_index(sorted_key[rank], idx_bits)).numel())
    return (8 * rank.numel() + 4 * n_words * entries + 8 * starts.shape[0]
            + (16 + 4) * out_pixels)


def blend_cutoff_flops(torch, KB, ent, starts, processed, *, tiles_x,
                       r2_cutoff, n_eyes: int = 2, pixel_coords=None,
                       tile_w: int = 16, tile_h: int = 16,
                       chunk: int = 1 << 15):
    """Float operations a blend with a cutoff (one eye or two) needs on
    this run's data: each record composited is decoded once an eye; each
    (pixel, record, eye) within the cutoff (q <= r2_cutoff) costs the whole
    composite, each one beyond it only its q, since its alpha is exactly 0.
    q is the plain version's, from the same decode.  Returns (flops, pairs
    within the cutoff, pairs)."""
    sorted_key, words, idx_bits = ent
    words = list(words)
    tile, rank = composited_ranks(torch, starts, processed)
    g = KB.entry_index(sorted_key[rank], idx_bits)
    t_x, t_y = tile % tiles_x, tile // tiles_x
    if pixel_coords is None:
        pix = torch.arange(tile_w * tile_h, device=starts.device)
        lx = (pix % tile_w).to(torch.float32)
        ly = (pix // tile_w).to(torch.float32)
    inside = 0
    for e in range(n_eyes):
        rec = KB.decode_records(words[4 * e:4 * e + 4])
        for c0 in range(0, g.numel(), chunk):
            gc, txc, tyc = g[c0:c0 + chunk], t_x[c0:c0 + chunk], t_y[c0:c0 + chunk]
            if pixel_coords is None:
                px = lx[None, :] + (txc * tile_w).to(torch.float32)[:, None]
                py = ly[None, :] + (tyc * tile_h).to(torch.float32)[:, None]
            else:
                px = pixel_coords[0][txc]
                py = pixel_coords[1][tyc]
            dx = px - rec["mx"][gc][:, None]
            dy = py - rec["my"][gc][:, None]
            u = rec["a1"][gc][:, None] * dx + rec["b1"][gc][:, None] * dy
            v = rec["a2"][gc][:, None] * dx + rec["b2"][gc][:, None] * dy
            inside += int(((u * u + v * v) <= r2_cutoff).sum())
    pairs = n_eyes * tile_w * tile_h * g.numel()
    flops = (n_eyes * BLEND_DECODE_FLOPS * g.numel() + BLEND_PAIR_FLOPS * inside
             + BLEND_Q_FLOPS * (pairs - inside))
    return flops, inside, pairs


def blend_reach_flops(torch, KB, ent, starts, processed, *, tiles_x,
                      tile_w, tile_h, n_eyes, r2_cutoff, pixel_coords=None,
                      tile_row_offset: int = 0):
    """Float operations that a blend which culls records by warp (the split
    layout's culling instances) cannot skip on this run's data: each record
    composited is decoded once an eye and box-tested once for each warp of
    its tile (at least pixels / 32 of them); a (pixel, record, eye) costs
    its q only within the record's reach (the kernel's reach_mask at the
    pixel: |pixel - mean|^2 <= BLEND_REACH_MARGIN * r2 * max(s1, s2)^2, r2
    the cutoff, or without one 2 * (log opacity - BLEND_EXP_ZERO)), and the
    rest of the composite only where also q <= r2 (elsewhere alpha is
    exactly 0).  Decode and q as the plain version's.  Returns (flops,
    pairs within reach and r2, pairs)."""
    sorted_key, words, idx_bits = ent
    words = list(words)
    tile, rank = composited_ranks(torch, starts, processed)
    g = KB.entry_index(sorted_key[rank], idx_bits)
    t_x, t_y = tile % tiles_x, tile // tiles_x
    pix = tile_w * tile_h
    if pixel_coords is None:
        p = torch.arange(pix, device=starts.device)
        lx = (p % tile_w).to(torch.float32)
        ly = (p // tile_w).to(torch.float32)

    def f16(bits):
        return (bits & 0xFFFF).to(torch.int16).view(torch.float16).float()

    chunk = max(1, (1 << 23) // pix)
    near = inside = 0
    for e in range(n_eyes):
        w = [x.to(torch.int64) for x in words[4 * e:4 * e + 4]]
        rec = KB.decode_records(words[4 * e:4 * e + 4])
        scale = torch.maximum(torch.clamp(f16(w[1] >> 16), min=1e-4),
                              torch.clamp(f16(w[2]), min=1e-4))
        r2 = (torch.full_like(scale, r2_cutoff) if r2_cutoff > 0
              else 2.0 * (rec["logop"] - BLEND_EXP_ZERO))
        lim = BLEND_REACH_MARGIN * r2 * scale * scale
        for c0 in range(0, g.numel(), chunk):
            gc, txc, tyc = g[c0:c0 + chunk], t_x[c0:c0 + chunk], t_y[c0:c0 + chunk]
            if pixel_coords is None:
                px = lx[None, :] + (txc * tile_w).to(torch.float32)[:, None]
                py = ly[None, :] + ((tyc + tile_row_offset)
                                    * tile_h).to(torch.float32)[:, None]
            else:
                px = pixel_coords[0][txc]
                py = pixel_coords[1][tyc]
            dx = px - rec["mx"][gc][:, None]
            dy = py - rec["my"][gc][:, None]
            within = (dx * dx + dy * dy) <= lim[gc][:, None]
            u = rec["a1"][gc][:, None] * dx + rec["b1"][gc][:, None] * dy
            v = rec["a2"][gc][:, None] * dx + rec["b2"][gc][:, None] * dy
            near += int(within.sum())
            inside += int((within & ((u * u + v * v) <= r2[gc][:, None])).sum())
    records = g.numel()
    flops = (n_eyes * (BLEND_DECODE_FLOPS + BLEND_BOX_FLOPS * -(-pix // 32))
             * records + BLEND_Q_FLOPS * near
             + (BLEND_PAIR_FLOPS - BLEND_Q_FLOPS) * inside)
    return flops, inside, n_eyes * pix * records


def blend_flops(torch, KB, ent, starts, processed, *, tiles_x, tile_w,
                tile_h, n_eyes: int = 1, r2_cutoff: float = 0.0,
                pixel_coords=None, tile_row_offset: int = 0):
    """Float operations the blend needs on this run's data, by the kernel
    that takes the tile (``KB.split_layout``): where records are culled by
    warp, blend_reach_flops; else with a cutoff blend_cutoff_flops, and
    without one the whole composite of every (pixel, record, eye).
    Returns (flops, pairs within the cutoff (all without one), pairs)."""
    layout = KB.split_layout(n_eyes, r2_cutoff, tile_w, tile_h)
    kw = dict(tiles_x=tiles_x, n_eyes=n_eyes, pixel_coords=pixel_coords,
              tile_w=tile_w, tile_h=tile_h)
    if layout is not None and layout[3]:
        return blend_reach_flops(torch, KB, ent, starts, processed,
                                 r2_cutoff=r2_cutoff,
                                 tile_row_offset=tile_row_offset, **kw)
    if r2_cutoff > 0:
        assert tile_row_offset == 0
        return blend_cutoff_flops(torch, KB, ent, starts, processed,
                                  r2_cutoff=r2_cutoff, **kw)
    records = float(processed.sum())
    pairs = n_eyes * tile_w * tile_h * records
    return (n_eyes * BLEND_DECODE_FLOPS * records + BLEND_PAIR_FLOPS * pairs,
            pairs, pairs)


def blend_subset_err(torch, KB, ent, starts, counts, color, depth, *,
                     tiles_x, tiles_y, w, h, n_eyes=1, r2_cutoff=0.0,
                     pixel_coords=None, depth_mode="weighted"):
    """Max |kernel - plain| over the 64 heaviest and 64 random tiles of
    each eye (the kernel's (H, n_eyes * W) images against the plain tiles;
    pixels of the padded edge tiles, outside w x h, are not written).
    ``ent``: (sorted_key, entry words, idx_bits)."""
    gen = torch.Generator().manual_seed(0)
    heavy = torch.argsort(counts.cpu(), descending=True)[:64]
    rand = torch.randperm(tiles_x * tiles_y, generator=gen)[:64]
    sub = torch.unique(torch.cat([heavy, rand])).to(counts.device)
    plain = KB.blend_tiles_plain(*ent, starts, counts, tiles_x=tiles_x,
                                 tiles=sub, n_eyes=n_eyes, r2_cutoff=r2_cutoff,
                                 pixel_coords=pixel_coords,
                                 depth_mode=depth_mode)
    eyes = plain if n_eyes == 2 else [plain]
    pix = torch.arange(256, device=sub.device)
    ys = (sub // tiles_x)[:, None] * 16 + pix[None, :] // 16
    xs = (sub % tiles_x)[:, None] * 16 + pix[None, :] % 16
    inside = (ys < h) & (xs < w)
    err = 0.0
    for e, (sc, sd) in enumerate(eyes):
        kc = color[ys.clamp(max=h - 1), xs.clamp(max=w - 1) + e * w]
        kd = depth[ys.clamp(max=h - 1), xs.clamp(max=w - 1) + e * w]
        err = max(err, float((kc - sc).abs()[inside].max()),
                  float((kd - sd).abs()[inside].max()))
    return err


def band_frame_fn(render, gi, cam):
    """``render`` (a world of one's band frame, whose rows are the whole
    image) as a frame loop's callable: an output with the colour, the depth
    and a header of the overflow flag (the header counts it does not
    report read -1)."""
    from types import SimpleNamespace

    def fn():
        color, depth, overflow = render(gi, cam.view_matrix,
                                        cam.projection_matrix, cam.position)
        return SimpleNamespace(color=color, depth=depth, header=SimpleNamespace(
            overflow=overflow, visible_count=-1, total_instances=-1,
            slot_total=-1, row_total=None))
    return fn


def band_slots(hist, band_starts, n_padded: int) -> int:
    """A band's slots: the padded count (every gathered gaussian takes a
    slot in every band) plus the largest band load of the row histogram,
    rounded up to a multiple of 4096."""
    load = max(int(hist[b0:b1].sum()) for b0, b1 in zip(band_starts,
                                                        band_starts[1:]))
    return -(-(n_padded + load) // 4096) * 4096


def mono_frame_at(T, gi, cam, capacity: int, tile_w: int, tile_h: int):
    """The mono DepthFirst chain at ``tile_w`` x ``tile_h`` tiles with a
    KeyPlan, rows off (``depth_first_frame``; the renderer's tile is
    16x16): the frame the band frames at that tile must reproduce."""
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame

    out = depth_first_frame(
        gi, cam.view_matrix, cam.projection_matrix, cam.position,
        cached_projection_inputs(gi, 3), width=W, height=H, capacity=capacity,
        sh_degree=3, alpha_threshold=T.config.DEFAULT_ALPHA_THRESHOLD,
        total_ink_threshold=T.config.DEFAULT_TOTAL_INK_THRESHOLD,
        near_plane=cam.near_plane, far_plane=cam.far_plane,
        input_is_srgb=False, tile_w=tile_w, tile_h=tile_h)
    if int(out.header.overflow) != 0:
        raise RuntimeError(f"the mono {tile_w}x{tile_h} frame overflowed")
    return out


def band_tile(kw) -> tuple:
    """The tile of a band frame's keywords (16x16 unless named)."""
    return kw.get("tile_w", 16), kw.get("tile_h", 16)


def _band_rank(rank: int, world: int, n: int, configs: list):
    """One spawned rank of phase 4m's gloo worlds on cuda:0: the headline
    scene's shard, then each (label, keywords of build_sharded_depth_first,
    early exit) of ``configs``: one warm-up frame, one frame with every
    kernel's count set to 0 just before it and read just after, the image
    gathered.  Rank 0 also renders the mono headline frame (the blend's
    early exit on and off; at other tiles :func:`mono_frame_at`) and
    compares the stitched image with it."""
    import torch
    import gsm_renderer_tpu_torch as T
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.parallel import multichip as MC

    ds = generate_visible_gaussians(n, sh_degree=3, seed=7,
                                    scale_range=(0.002, 0.012))
    cam = T.make_camera(W, H, far=50.0)
    args = (cam.view_matrix, cam.projection_matrix, cam.position)
    exit_t = KB.MIN_TRANSMITTANCE
    mono = {}
    if rank == 0:
        gi = ds.to_input(T.Precision.FLOAT32)
        r = T.DepthFirstRenderer(T.RendererConfig(
            sh_degree=3, precision=T.Precision.FLOAT32, max_width=W,
            max_height=H))
        tiles = {band_tile(kw) for _label, kw, _exit in configs}
        for early_exit in (True, False):
            KB.MIN_TRANSMITTANCE = exit_t if early_exit else 0.0
            for _ in range(3):
                out = r.render(gi, cam, W, H)
            mono[((16, 16), early_exit)] = out
            for tile in tiles - {(16, 16)}:
                mono[(tile, early_exit)] = mono_frame_at(
                    T, gi, cam, -(-4 * n // 4096) * 4096, *tile)
        KB.MIN_TRANSMITTANCE = exit_t
    gi = MC.shard_gaussian_input(ds.to_input(T.Precision.FLOAT32), rank, world)
    kernels = (KP.PROJECT, KE.PREP, KE.PREP_BAND, KE.EXPAND, KB.BLEND)
    res = []
    for label, kw, early_exit in configs:
        KB.MIN_TRANSMITTANCE = exit_t if early_exit else 0.0
        try:
            render = MC.build_sharded_depth_first(
                width=W, height=H, n_total=n, sh_degree=3,
                near_plane=cam.near_plane, far_plane=cam.far_plane, **kw)
            render(gi, *args)
            for k in kernels:
                k.launches = 0
            color, depth, overflow = render(gi, *args)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in kernels}
            color, depth = render.gather(color, depth)
        finally:
            KB.MIN_TRANSMITTANCE = exit_t
        row = dict(label=label, overflow=int(overflow), launches=launches,
                   band_starts=list(render.band_starts),
                   capacity=render.capacity,
                   plan=None if render.key_plan is None
                   else list(render.key_plan.kernel_tuple))
        if rank == 0:
            ref = mono[(band_tile(kw), early_exit)]
            d = (color - ref.color).abs()
            row.update(
                equal=bool(torch.equal(color, ref.color)
                           and torch.equal(depth, ref.depth)),
                max_abs_err=float(d.max()),
                depth_max_abs_err=float((depth - ref.depth).abs().max()),
                pixels_differ=int((d.amax(-1) > 0).sum()),
                finite=bool(torch.isfinite(color).all()),
                nonblack=float((color[..., :3].amax(-1) > 0.02).float().mean()))
        res.append(row)
    return res


def phase_multichip(torch, T, kernels, hl, tiles8, odd, large):
    """Phase 4m: the band-sharded frame of the headline scene.  A world of
    one over NCCL in this process (the KeyPlan and the stable fallback, each
    bit-equal to the headline frame; at 32x16, 8x8, ODD_TILE and LARGE_TILE
    tiles, bit-equal to the mono frame at that tile, ``tiles8``, ``odd``
    and ``large`` phase 4t's 8x8, phase 4o's ODD_TILE and phase 4L's
    LARGE_TILE rows-off frames; frame times, split and trace beside the
    headline's rows-off frame); prep
    "band", the expand with a tile row
    offset and the blend with one on band 1 of 4 against their plain
    versions; worlds of 2 and 4 spawned gloo ranks on this card with equal
    and balanced bands (stitched image against the headline frame, bit for
    bit with the blend's early exit off), and at a tiny capacity
    (overflow 1 on every rank)."""
    import tempfile

    import torch.distributed as dist
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.parallel import multichip as MC

    gi, cam, n = hl["gi"], hl["cam"], hl["n"]
    args = (cam.view_matrix, cam.projection_matrix, cam.position)
    kw = dict(width=W, height=H, n_total=n, sh_degree=3,
              near_plane=cam.near_plane, far_plane=cam.far_plane)
    tiles_y = -(-H // 16)
    hist = MC.row_instance_histogram(
        gi, *args, width=W, height=H, sh_degree=3, near_plane=cam.near_plane,
        far_plane=cam.far_plane)
    refs = {(16, 16): (hl["out"], hl["off_capacity"]),
            (32, 16): (mono_frame_at(T, gi, cam, hl["off_capacity"], 32, 16),
                       hl["off_capacity"]),
            (8, 8): (tiles8["off"], tiles8["cap_off"]),
            ODD_TILE: (odd["off"], odd["cap_off"]),
            LARGE_TILE: (large["off"], large["cap_off"])}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            for label, use_kp, tile in (("keyplan", True, (16, 16)),
                                        ("tile_key", False, (16, 16)),
                                        ("keyplan_32x16", True, (32, 16)),
                                        ("keyplan_8x8", True, (8, 8)),
                                        ("keyplan_odd", True, ODD_TILE),
                                        ("keyplan_large", True, LARGE_TILE)):
                ref, cap = refs[tile]
                render = MC.build_sharded_depth_first(
                    use_keyplan=use_kp, capacity_per_device=cap,
                    tile_w=tile[0], tile_h=tile[1], **kw)
                fn = band_frame_fn(render, gi, cam)
                out, stats, launches = drive_path(
                    torch, kernels, BAND_PATH, f"band world 1 {label}",
                    lambda fn=fn: timed_frames(torch, fn, n_lock=0))
                if int(out.header.overflow) != 0:
                    raise RuntimeError(f"band world 1 {label}: overflow")
                if not (torch.equal(out.color, ref.color)
                        and torch.equal(out.depth, ref.depth)):
                    raise RuntimeError(f"band world 1 {label}: differs from "
                                       f"the mono frame at {tile[0]}x"
                                       f"{tile[1]}")
                stats = dict(avg=stats["avg"], min=stats["min"],
                             max=stats["max"], split=frame_split(torch, fn),
                             launches=launches, equal_to_mono=True,
                             tile=f"{tile[0]}x{tile[1]}", capacity=cap)
                trace = trace_frames(torch, fn, f"band world 1 {label} trace",
                                     frames=5)
                require_one_pass_scan(trace, f"band world 1 {label}")
                stats["trace"] = trace
                res[f"world_1_{label}"] = stats
            log("[multichip] " + json.dumps({
                "band_world_1": res, "headline_rows_off": hl["stats"]["rows_off"],
                "headline": {k: hl["stats"][k] for k in ("avg", "min", "max",
                                                         "split")}}))
        finally:
            dist.destroy_process_group()

    n_padded = {w: n + (-n) % w for w in (2, 4)}
    for world in (2, 4):
        eq, _bands = MC.resolve_band_starts(tiles_y, world)
        bal = MC.balance_band_starts(hist, world)
        configs = []
        for label, bs in (("equal", None), ("balanced", bal)):
            cap = band_slots(hist, eq if bs is None else bs,
                                n_padded[world])
            for early_exit in (True, False):
                configs.append((f"{label}{'' if early_exit else ' no exit'}",
                                dict(band_starts=bs, capacity_per_device=cap),
                                early_exit))
        if world == 4:
            cap = band_slots(hist, eq, n_padded[world])
            for early_exit in (True, False):
                configs.append((f"equal 32x16{'' if early_exit else ' no exit'}",
                                dict(capacity_per_device=cap, tile_w=32),
                                early_exit))
            # the band histogram is of 16-pixel rows: at ODD_TILE the
            # capacity is the padded count plus the largest band's load
            # of the frame's slots (the world of one's capacity covers it)
            for early_exit in (True, False):
                configs.append((f"equal odd{'' if early_exit else ' no exit'}",
                                dict(capacity_per_device=odd["cap_off"],
                                     tile_w=ODD_TILE[0], tile_h=ODD_TILE[1]),
                                early_exit))
            configs.append(("tiny capacity", dict(capacity_per_device=4096),
                            True))
        t0 = time.perf_counter()
        ranks = MC.run_ranks(_band_rank, world, n, configs)
        seconds = time.perf_counter() - t0
        if world == 4:
            # the launches of rank 1 (band 1 of 4, a non-zero tile row
            # offset) in the equal-band frames, for the band kernels' rows
            labels = [c[0] for c in configs]
            band_launches = {
                (16, 16): ranks[1][labels.index("equal")]["launches"],
                (32, 16): ranks[1][labels.index("equal 32x16")]["launches"],
                ODD_TILE: ranks[1][labels.index("equal odd")]["launches"]}
            if ranks[1][0]["band_starts"][1] <= 0:
                raise RuntimeError("world 4: rank 1's band starts at row 0")
        for k, (label, _kw, early_exit) in enumerate(configs):
            per = [r[k] for r in ranks]
            ref = per[0]
            tiny = label == "tiny capacity"
            for rank, row in enumerate(per):
                bad = [p for p in BAND_PATH if row["launches"][p] <= 0]
                if bad:
                    raise RuntimeError(f"world {world} {label} rank {rank}: "
                                       f"{bad} not launched")
                if row["overflow"] != int(tiny):
                    raise RuntimeError(f"world {world} {label} rank {rank}: "
                                       f"overflow {row['overflow']}")
            if not (ref["finite"] and ref["nonblack"] > 0.0):
                raise RuntimeError(f"world {world} {label}: not finite or black")
            if tiny:
                continue
            if not early_exit and not ref["equal"]:
                raise RuntimeError(f"world {world} {label}: the stitched image "
                                   "differs from the mono frame with the "
                                   "early exit off")
            if (ref["max_abs_err"] >= KB.MIN_TRANSMITTANCE
                    or ref["depth_max_abs_err"] >= KB.MIN_TRANSMITTANCE * 50.0):
                raise RuntimeError(f"world {world} {label}: differs from the "
                                   f"mono frame beyond the exit bound: "
                                   f"{ref}")
        log(f"[multichip] world {world}: " + json.dumps(
            dict(seconds=seconds, configs=[
                dict(per_rank=[{k: r[j][k] for k in ("overflow", "launches")}
                               for r in ranks], **{
                    k: v for k, v in ranks[0][j].items()
                    if k not in ("overflow", "launches")})
                for j in range(len(configs))])))
    rows = [row for tile in ((16, 16), (32, 16), ODD_TILE)
            for row in band_kernel_rows(torch, hl, band_launches[tile],
                                        *tile)]
    rows += band_kernel_rows(torch, hl, res["world_1_keyplan_8x8"]["launches"],
                             8, 8)
    rows += band_kernel_rows(torch, hl,
                             res["world_1_keyplan_large"]["launches"],
                             *LARGE_TILE)
    sort_rows, other = stable_sort_rows(torch, hl, res)
    return rows + sort_rows, other


def tested_entries(off, rect, masked_too=False) -> float:
    """Live entries whose words the expand's exact test reads."""
    owns = (off[1:] - off[:-1]) > 0
    ru = rect.long() & 0xFFFFFFFF
    bits = 1 if masked_too else 3   # culled (and, unless warped, masked)
    return float((owns & (((ru >> 30) & bits) == 0)).sum())


def expand_bytes(n_entries, capacity, words_read) -> float:
    """Bytes of an expand: the offset, rect, mask and depth word of each
    entry, the tested entries' words, the two keys of each slot."""
    return (n_entries + 1) * 4 + 3 * 4 * n_entries + 4 * words_read \
        + 2 * 4 * capacity


def tile_tests(rect_word, rect_h) -> float:
    """Window tests prep runs: min(rect_w, 8) * min(rect_h, 4) a gaussian."""
    rw = rect_word.long() & 0xFFFFFFFF
    return float((((rw >> 20) & 0x3FF).clamp(max=8)
                  * rect_h.long().clamp(max=4)).sum())


def tested_slots(off, rect, masked_too=False) -> float:
    """Slots the expand tests: those of unmasked live entries (with the
    MASKED ones too under the warp, which re-tests them)."""
    counts_g = (off[1:] - off[:-1]).long()
    ru = rect.long() & 0xFFFFFFFF
    if masked_too:
        return float(counts_g[((ru >> 30) & 1) == 0].sum())
    return float(counts_g[((ru >> 30) & 3) == 0].sum())


def kernel_row(name, kernel, launches, ms, plain_ms, err, nbytes, flops):
    """One row of the ``kernels`` line, its bound from this run's bytes and
    operations; logged."""
    b, by = bound(nbytes, flops)
    src, replaces = KERNEL_SOURCES[kernel]
    log(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
        f"{b:.4f} ms by {by}), max_abs_err {err}")
    return dict(name=name, route="cuda", source=src, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None, flips=0.0)


def require_exact(torch, name, pairs):
    """Fails unless every int tensor pair is equal."""
    bad, total, worst = mismatches(torch, pairs)
    if bad:
        raise RuntimeError(f"{name}: {bad} of {total} outputs differ "
                           f"(max |d| {worst})")


def band_kernel_rows(torch, hl, band_launches, tile_w: int, tile_h: int = 16):
    """Prep "band", the expand with a tile row offset and the blend with one
    on band 1 of 4 of the headline scene at ``tile_w`` x ``tile_h`` tiles,
    each against its plain version; returns their kernel rows (at tiles
    other than 16x16 named with the suffix ".<w>x<h>").  The launches are
    ``band_launches``: rank 1's in the gloo world of 4 with equal bands at
    that tile (the same band, a non-zero offset), or at 8x8 the world of
    one's (the same kernel modes at row offset 0)."""
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.parallel import multichip as MC
    from gsm_renderer_tpu_torch.pipelines import common as PC

    gi, cam, n, cfg = hl["gi"], hl["cam"], hl["n"], hl["cfg"]
    tiles_x, tiles_y = -(-W // tile_w), -(-H // tile_h)
    suffix = "" if (tile_w, tile_h) == (16, 16) else f".{tile_w}x{tile_h}"
    bs, bands = MC.resolve_band_starts(tiles_y, 4)
    band0, band1 = bs[1], bs[2]
    block = MC.project_block(
        gi, cam.view_matrix, cam.projection_matrix, cam.position, width=W,
        height=H, tile_w=tile_w, tile_h=tile_h, sh_degree=3,
        near_plane=cam.near_plane, far_plane=cam.far_plane,
        alpha_threshold=cfg.alpha_threshold,
        total_ink_threshold=cfg.total_ink_threshold, input_is_srgb=False)
    words = list(block[:4])
    plan = OB.make_key_plan(tiles_x * bands, n, near_plane=cam.near_plane,
                            far_plane=cam.far_plane)
    rows = []

    bkw = dict(band0=band0, band1=band1, key_plan=plan)
    prep_in = (block[4], block[5], block[6], block[7])
    pk, ms = device_ms(torch, lambda: KE.binning_prep_band_cuda(*prep_in, **bkw),
                       20)
    pp, plain_ms = cuda_ms(torch,
                           lambda: KE.binning_prep_band_plain(*prep_in, **bkw), 3)
    require_exact(torch, "prep.band" + suffix, list(zip(pk, pp)))
    # four planes read, the offsets and three planes written
    rows.append(kernel_row("prep.band" + suffix, "prep",
                           band_launches["prep_band"], ms, plain_ms, 0.0,
                           4 * 4 * n + 4 * (n + 1) + 3 * 4 * n, 0.0))
    offsets, rect, mask, dsw = pk
    total = int(offsets[n])
    cap = -(-total // 4096) * 4096
    counts_g = (offsets[1:] - offsets[:-1]).to(torch.int64)
    ru = rect.to(torch.int64) & 0xFFFFFFFF
    tested = ((ru >> 30) & 3) == 0   # live and not pre-counted
    n_tested = float(counts_g[tested].sum())
    tested_words = 4 * 4 * float(tested.sum())
    ekw = dict(capacity=cap, tiles_x=tiles_x, key_plan=plan,
               tile_row_offset=band0, tile_w=tile_w, tile_h=tile_h)
    exp_in = (offsets, rect, mask, dsw, words)
    ek, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*exp_in, **ekw), 20)
    ep, plain_ms = cuda_ms(torch, lambda: KE.expand_slots_plain(*exp_in, **ekw),
                           3)
    require_exact(torch, "expand.offset" + suffix, list(zip(ek, ep)))
    # the offset, rect, mask and depth word of each entry, the tested
    # entries' words, two keys a slot
    rows.append(kernel_row(
        "expand.offset" + suffix, "expand", band_launches["expand"], ms,
        plain_ms, 0.0, 4 * (n + 1) + 3 * 4 * n + tested_words + 2 * 4 * cap,
        (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS) * n_tested))
    log(f"[multichip] band 1 of 4 at {tile_w}x{tile_h} (tile rows "
        f"{band0}-{band1}): "
        f"{total} slots of {cap}, {int((ek[0] != -1).sum())} live")

    srt = PC.sort_and_ranges(ek[:2], plan, tiles_x * bands)
    ent = (srt.key, words, srt.idx_bits)
    bl_kw = dict(tiles_x=tiles_x, tiles_y=bands, width=W,
                 height=bands * tile_h, tile_w=tile_w, tile_h=tile_h,
                 tile_row_offset=band0)
    (color, depth), ms = device_ms(
        torch, lambda: KB.blend_image_cuda(*ent, srt.starts, srt.counts,
                                           **bl_kw), 10)
    (pc, pd, processed), plain_ms = once_ms(
        torch, lambda: KB.blend_tiles_plain(
            *ent, srt.starts, srt.counts, tiles_x=tiles_x, tile_w=tile_w,
            tile_h=tile_h, tile_row_offset=band0, return_processed=True))
    pcol, pdep = KB.assemble_image(pc, pd, tiles_x=tiles_x, tiles_y=bands,
                                   width=W, height=bands * tile_h,
                                   tile_w=tile_w, tile_h=tile_h)
    err = max(float((pcol - color).abs().max()),
              float((pdep - depth).abs().max()))
    if err != 0.0:
        raise RuntimeError(f"blend.offset{suffix}: kernel vs plain max |d| "
                           f"{err}")
    rows.append(kernel_row(
        "blend.offset" + suffix, "blend", band_launches["blend"], ms,
        plain_ms, err,
        blend_bytes(torch, KB, ent, srt.starts, processed, 4,
                    W * bands * tile_h),
        blend_flops(torch, KB, ent, srt.starts, processed, tiles_x=tiles_x,
                    tile_w=tile_w, tile_h=tile_h, tile_row_offset=band0)[0]))
    if (tile_w, tile_h) == (16, 16):
        d_head = float((color[:(band1 - band0) * 16]
                        - hl["out"].color[band0 * 16:band1 * 16]).abs().max())
        log(f"[multichip] band 1 of 4 blended: max |d| {d_head:.3g} to the "
            "headline frame's rows (the exit aligned to the band's list)")
    return rows


def stable_sort_rows(torch, hl, world_1):
    """Over the slots of the whole headline frame (a band of all 68 rows: a
    world of one), the tile-key expand against its plain version and the
    stable sort beside the keys-only sort (the same ranks).  Returns the
    kernel row (the launches of the world of one's stable frame,
    ``world_1``) and the library op."""
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.parallel import multichip as MC
    from gsm_renderer_tpu_torch.pipelines import common as PC

    gi, cam, n, cfg = hl["gi"], hl["cam"], hl["n"], hl["cfg"]
    tiles_x, tiles_y = -(-W // 16), -(-H // 16)
    block = MC.project_block(
        gi, cam.view_matrix, cam.projection_matrix, cam.position, width=W,
        height=H, tile_w=16, tile_h=16, sh_degree=3,
        near_plane=cam.near_plane, far_plane=cam.far_plane,
        alpha_threshold=cfg.alpha_threshold,
        total_ink_threshold=cfg.total_ink_threshold, input_is_srgb=False)
    words = list(block[:4])
    prep_in = (block[4], block[5], block[6], block[7])
    full_plan = OB.make_key_plan(tiles_x * tiles_y, n,
                                 near_plane=cam.near_plane,
                                 far_plane=cam.far_plane)
    cap_f = hl["off_capacity"]
    ops, rows = {}, []
    for label, p in (("keyplan", full_plan), ("tile_key", None)):
        off_f, rect_f, mask_f, dsw_f = KE.binning_prep_band_cuda(
            *prep_in, band0=0, band1=tiles_y, key_plan=p)
        fin = (off_f, rect_f, mask_f, dsw_f, words)
        fkw = dict(capacity=cap_f, tiles_x=tiles_x, key_plan=p)
        ops[label] = KE.expand_slots_cuda(*fin, **fkw)
        if label == "tile_key":
            fk, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*fin, **fkw),
                               20)
            fp, plain_ms = cuda_ms(
                torch, lambda: KE.expand_slots_plain(*fin, **fkw), 3)
            require_exact(torch, "expand.tile_key", list(zip(fk, fp)))
            ru = rect_f.to(torch.int64) & 0xFFFFFFFF
            cg = (off_f[1:] - off_f[:-1]).to(torch.int64)
            tst = ((ru >> 30) & 3) == 0
            # as the KeyPlan expand, plus the entry plane
            rows.append(kernel_row(
                "expand.tile_key", "expand",
                world_1["world_1_tile_key"]["launches"]["expand"], ms,
                plain_ms, 0.0, 4 * (n + 1) + 3 * 4 * n + 16 * float(tst.sum())
                + 3 * 4 * cap_f,
                (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS) * float(cg[tst].sum())))
    k1, k2 = ops["keyplan"][:2]
    t1, t2, entry = ops["tile_key"][:3]
    _, unstable_ms = device_ms(torch, lambda: PC.sort_instances(k1, k2), 10)
    _, stable_ms = device_ms(
        torch, lambda: PC.sort_instances_stable(t1, t2, entry), 10)
    srt_u = PC.sort_and_ranges(ops["keyplan"][:2], full_plan, tiles_x * tiles_y)
    srt_s = PC.sort_and_ranges(ops["tile_key"][:3], None, tiles_x * tiles_y)
    live = int(srt_u.counts.sum())
    if not (torch.equal(srt_u.starts, srt_s.starts)
            and torch.equal(KB.entry_index(srt_u.key[:live], srt_u.idx_bits),
                            srt_s.key[:live])):
        raise RuntimeError("stable sort: ranks differ from the KeyPlan sort's")
    other = [dict(name="stable sort (torch.sort(stable=True) of the (tile, "
                  "depth) int64 keys, with indices, and the entry gather)",
                  ms=stable_ms, elements=cap_f,
                  # keys read and written, indices written, entries gathered
                  bound_ms=(16 + 8 + 12) * cap_f / HBM_BYTES_PER_S * 1e3,
                  keys_only_unstable_ms=unstable_ms)]
    log(f"[library] stable sort {stable_ms:.4f} ms vs keys-only unstable "
        f"sort {unstable_ms:.4f} ms over {cap_f} slots ({live} live); same "
        "ranks")
    return rows, other


def phase_fallback(torch, T, kernels, hl):
    """Phase 4s: the stable-sort fallback.  A mono DepthFirst frame of 4M
    gaussians, SH3, 3840x2160, far 1000, where no tie-free KeyPlan fits
    (frame times, launch counts, overflow 0, finite, non-black), its
    tile-key expand bit-equal to the plain version on the frame's tensors;
    and the headline frame through the chain with the plan set to None,
    bit-equal to the headline frame."""
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC

    n, w, h, far = FALLBACK_N, FALLBACK_W, FALLBACK_H, FALLBACK_FAR
    tiles_x, tiles_y = -(-w // 16), -(-h // 16)
    plan = OB.make_key_plan(tiles_x * tiles_y, n, near_plane=0.1,
                            far_plane=far)
    log(f"[fallback] make_key_plan({tiles_x * tiles_y}, {n}, near_plane=0.1, "
        f"far_plane={far}) = {plan}")
    if plan is not None:
        raise RuntimeError("fallback: a KeyPlan fits, the fallback is not run")
    ds = generate_visible_gaussians(n, sh_degree=3, seed=7,
                                    scale_range=(0.001, 0.006))
    gi = ds.to_input(T.Precision.FLOAT32)
    cam = T.make_camera(w, h, far=far)
    cfg = T.RendererConfig(sh_degree=3, precision=T.Precision.FLOAT32,
                           max_width=w, max_height=h)
    r = T.DepthFirstRenderer(cfg)
    render = lambda: r.render(gi, cam, w, h)
    out, stats, launches = drive_path(torch, kernels, MONO_RECTS_PATH,
                                      "fallback 4K",
                                      lambda: timed_frames(torch, render))
    check_frame(torch, out, "fallback 4K")
    if launches["row_expand"] != 0:
        raise RuntimeError("fallback 4K: rows ran without a KeyPlan")
    capacity = r._cap_state[(r._mono_key, n)]["cap"]
    stats.update(capacity=capacity, split=frame_split(torch, render),
                 trace=trace_frames(torch, render, "fallback 4K trace",
                                    frames=5))
    log("[fallback] " + json.dumps({"fallback_4k_frame_ms": stats}))

    pk = KP.project_cuda(*KP.cached_projection_inputs(gi, 3), cam.view_matrix,
                         cam.projection_matrix, cam.position, width=w,
                         height=h, tile_w=16, tile_h=16, sh_degree=3,
                         near_plane=cam.near_plane, far_plane=far,
                         alpha_threshold=cfg.alpha_threshold,
                         total_ink_threshold=cfg.total_ink_threshold,
                         input_is_srgb=False, key_plan=None)
    off, rect, mask = KE.binning_prep_cuda(pk.rect_word, pk.rect_h, pk.words)
    ekw = dict(capacity=capacity, tiles_x=tiles_x, key_plan=None)
    exp_in = (off, rect, mask, pk.dsw, pk.words)
    ek = KE.expand_slots_cuda(*exp_in, **ekw)
    ep = KE.expand_slots_plain(*exp_in, **ekw)
    bad, total, worst = mismatches(torch, list(zip(ek, ep)))
    if bad:
        raise RuntimeError(f"fallback 4K: the tile-key expand differs from "
                           f"its plain version at {bad} of {total}")
    srt = PC.sort_and_ranges(ek[:3], None, tiles_x * tiles_y)
    color, _depth = KB.blend_image_cuda(srt.key, pk.words, 32, srt.starts,
                                        srt.counts, tiles_x=tiles_x,
                                        tiles_y=tiles_y, width=w, height=h)
    if not torch.equal(color, out.color):
        raise RuntimeError("fallback 4K: the staged frame differs from the "
                           "renderer's")
    log(f"[fallback] 4K tile-key expand bit-equal to its plain version over "
        f"{capacity} slots ({int(ek[3])} filled); staged frame equal")

    hkw = dict(width=W, height=H, capacity=hl["off_capacity"],
               tiles_x=-(-W // 16), tiles_y=-(-H // 16), tile_w=16, tile_h=16,
               sh_degree=3, alpha_threshold=hl["cfg"].alpha_threshold,
               total_ink_threshold=hl["cfg"].total_ink_threshold,
               near_plane=hl["cam"].near_plane, far_plane=hl["cam"].far_plane,
               input_is_srgb=False)
    hcam = hl["cam"]
    hs, _packed, words, _total, overflow = PC.mono_packed_sorted(
        hl["gi"], hcam.view_matrix, hcam.projection_matrix, hcam.position,
        key_plan=None, **hkw)
    hc, hd = KB.blend_image_cuda(hs.key, words, hs.idx_bits, hs.starts,
                                 hs.counts, tiles_x=hkw["tiles_x"],
                                 tiles_y=hkw["tiles_y"], width=W, height=H)
    if int(overflow) != 0 or not (torch.equal(hc, hl["out"].color)
                                  and torch.equal(hd, hl["out"].depth)):
        raise RuntimeError("fallback: the headline chain with no KeyPlan "
                           "differs from the headline frame")
    log("[fallback] the headline chain with the plan set to None is "
        "bit-equal to the headline frame")


#: phase 4t: the mono headline frame (rows on) at these tiles, the stereo
#: frame and the foveated frame at theirs (8-pixel sides put the foveated
#: 1080p physical grid past the bounds table's 127 tiles an axis, as in
#: JAX)
TILE_MONO = ((8, 8), (16, 8), (8, 16), (32, 32), (32, 16))
TILE_STEREO = ((32, 16), (8, 8))
TILE_FOVEATED = ((32, 16), (32, 32))
#: phase 4o: tile sides that are not powers of two (and 64x64, the
#: split blend's cluster of eight CTAs): the mono frame with rows at every
#: ODD_MONO tile; the stereo (and its two-eye blend without a cutoff),
#: foveated, Hardware, Local and band frames at ODD_TILE; the Global frame
#: at ODD_GLOBAL
ODD_MONO = ((24, 24), (12, 12), (20, 12), (48, 16), (64, 64), (7, 5))
ODD_TILE = (24, 24)
ODD_GLOBAL = (48, 16)
#: phase 4L: tile sides over 64 pixels (the blend's large-tile path above
#: 4096 pixels a tile): the mono frame with rows at every LARGE_MONO tile;
#: the stereo frame (and its two-eye blend without a cutoff) and the Local
#: frame at LARGE_STEREO; the foveated, Hardware and band frames at
#: LARGE_TILE; the Global frame at LARGE_GLOBAL with and without the exact
#: tile test
LARGE_MONO = ((65, 65), (96, 80), (128, 64), (128, 128))
LARGE_TILE = (128, 128)
LARGE_STEREO = (96, 96)
LARGE_GLOBAL = (128, 64)
#: phase 4t's probe capacity, slots a gaussian, before a frame's own
TILE_PROBE_SLOTS = 32
#: phase 4t's per-tile clamp on the realistic scene
TILE_MAX_PER_TILE = 2048


def fit_capacity(slots: int) -> int:
    """A frame's capacity for ``slots``: 10% above, rounded up to 4096."""
    return -(-int(1.1 * slots + 1) // 4096) * 4096


def probed_capacity(run, n: int) -> int:
    """The capacity of a frame function ``run(capacity)``: one frame at
    TILE_PROBE_SLOTS slots a gaussian, then :func:`fit_capacity` of its
    slot total."""
    out = run(TILE_PROBE_SLOTS * -(-n // 4096) * 4096)
    if int(out.header.overflow) != 0:
        raise RuntimeError("probe frame overflowed")
    return fit_capacity(int(out.header.slot_total))


def fixed_frame_loop(torch, kernels, path, label, render, halves=1,
                     split_frames=5):
    """A frame function at a fixed capacity through :func:`drive_path` (one
    warm-up and five timed frames), the frame gate, its split and a traced
    device split by stage."""
    out, stats, launches = drive_path(
        torch, kernels, path, label,
        lambda: timed_frames(torch, render, n_lock=0, n_warm=1, n_timed=5))
    check_frame(torch, out, label, halves=halves)
    stats.update(split=frame_split(torch, render, frames=split_frames),
                 launches=launches)
    trace = trace_frames(torch, render, f"{label} trace", frames=5)
    require_one_pass_scan(trace, label)
    stats["trace"] = trace
    return out, stats, launches


def timed_pair(torch, name, cuda_fn, plain_fn, reps=10, plain_reps=1):
    """(kernel result, kernel ms, plain result, plain ms): the kernel timed
    behind a sleep kernel, its plain version as it runs."""
    got, ms = device_ms(torch, cuda_fn, reps)
    want, plain_ms = cuda_ms(torch, plain_fn, plain_reps)
    return got, ms, want, plain_ms


def blend_rows_check(torch, KB, name, ent, starts, counts, kernel_out, plain_kw,
                     *, tiles_x, tiles_y, width, height, tile_w, tile_h,
                     n_eyes=1):
    """The plain blend of the whole frame against the kernel's images
    (``kernel_out``): (plain ms, records composited a tile), failing unless
    bit-equal."""
    res, plain_ms = once_ms(torch, lambda: KB.blend_tiles_plain(
        *ent, starts, counts, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
        n_eyes=n_eyes, return_processed=True, **plain_kw))
    eyes, processed = ((res[:2],), res[2]) if n_eyes == 1 else res
    full = [KB.assemble_image(tc, td, tiles_x=tiles_x, tiles_y=tiles_y,
                              width=width, height=height, tile_w=tile_w,
                              tile_h=tile_h) for tc, td in eyes]
    color, depth = kernel_out
    err = float((torch.cat([c for c, _ in full], 1) - color).abs().max())
    if depth is not None:
        err = max(err, float((torch.cat([d for _, d in full], 1)
                              - depth).abs().max()))
    if err != 0.0:
        raise RuntimeError(f"{name}: kernel vs plain max |d| {err}")
    return plain_ms, processed


def mono_tile_rows(torch, T, hl, tile, fr):
    """The kernels of the mono frame at ``tile`` (rows on; rows off where
    ``fr["row_cap"]`` is 0) on its own tensors: project, prep counting
    rows, the row expand, the expand and the blend, each bit-equal to its
    plain version, the staged frame bit-equal to the frame function's;
    their kernel rows."""
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC

    tw, th = tile
    tag = f"{tw}x{th}"
    n, cam, cfg, launches = hl["n"], hl["cam"], hl["cfg"], fr["launches"]
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    comp, harm = KP.cached_projection_inputs(hl["gi"], 3)
    r_cap = fr["row_cap"]
    plan = OB.make_key_plan(tiles_x * tiles_y, r_cap or n,
                            near_plane=cam.near_plane, far_plane=cam.far_plane)
    pkw = dict(width=W, height=H, tile_w=tw, tile_h=th, sh_degree=3,
               near_plane=cam.near_plane, far_plane=cam.far_plane,
               alpha_threshold=cfg.alpha_threshold,
               total_ink_threshold=cfg.total_ink_threshold,
               input_is_srgb=False, key_plan=plan)
    args = (comp, harm, cam.view_matrix, cam.projection_matrix, cam.position)
    rows = []
    pk, ms, pp, plain_ms = timed_pair(
        torch, "project", lambda: KP.project_cuda(*args, **pkw),
        lambda: KP.project_plain(*args, **pkw))
    require_exact(torch, f"project.{tag}", [
        (pk.rect_word, pp.rect_word), (pk.rect_h, pp.rect_h),
        (pk.dsw, pp.dsw), (pk.visible, pp.visible)]
        + list(zip(pk.words, pp.words)))
    rows.append(kernel_row(f"project.{tag}", "project", launches["project"],
                           ms, plain_ms, 0.0,
                           (11 + harm.shape[0]) * 4 * n + (7 * 4 + 1) * n,
                           PROJECT_FLOPS * n))
    bkw = dict(tile_w=tw, tile_h=th)
    prep_in = (pk.rect_word, pk.rect_h, pk.words)
    count_rows = r_cap > 0
    (off, rect, mask), ms, prep_p, plain_ms = timed_pair(
        torch, "prep",
        lambda: KE.binning_prep_cuda(*prep_in, count_rows=count_rows, **bkw),
        lambda: KE.binning_prep_plain(*prep_in, count_rows=count_rows, **bkw))
    require_exact(torch, f"prep.{tag}", list(zip((off, rect, mask), prep_p)))
    rows.append(kernel_row(
        f"prep.{tag}", "prep", launches["prep"], ms, plain_ms, 0.0,
        (6 + 3) * 4 * n + 4,
        PREP_DECODE_FLOPS * n + TILE_TEST_FLOPS * tile_tests(pk.rect_word,
                                                             pk.rect_h)))
    tab, n_tab = (off, rect, mask, pk.dsw, pk.words), n
    if count_rows:
        row_in = (off, rect, mask, pk.dsw, pk.words)
        rk, ms, rp, plain_ms = timed_pair(
            torch, "row_expand",
            lambda: KE.row_expand_cuda(*row_in, row_capacity=r_cap, **bkw),
            lambda: KE.row_expand_plain(*row_in, row_capacity=r_cap, **bkw))
        require_exact(torch, f"row_expand.{tag}", [
            (rk[k], rp[k]) for k in (0, 1, 2, 3, 5)] + list(zip(rk[4], rp[4])))
        ru = rect.long() & 0xFFFFFFFF
        oversized_rows = float((off[1:] - off[:-1]).long()[
            ((ru >> 30) & 3) == 0].sum())
        rows.append(kernel_row(
            f"row_expand.{tag}", "row_expand", launches["row_expand"], ms,
            plain_ms, 0.0,
            (n + 1) * 4 + 7 * 4 * n + (r_cap + 1) * 4 + 7 * 4 * r_cap,
            ROW_SPAN_FLOPS * oversized_rows))
        tab, n_tab = tuple(rk[:5]), r_cap
    cap = fr["cap"]
    ekw = dict(capacity=cap, tiles_x=tiles_x, key_plan=plan, **bkw)
    exp_in = tab
    ek, ms, ep, plain_ms = timed_pair(
        torch, "expand", lambda: KE.expand_slots_cuda(*exp_in, **ekw),
        lambda: KE.expand_slots_plain(*exp_in, **ekw), plain_reps=1)
    require_exact(torch, f"expand.{tag}", list(zip(ek, ep)))
    rows.append(kernel_row(
        f"expand.{tag}", "expand", launches["expand"], ms, plain_ms, 0.0,
        expand_bytes(n_tab, cap, 4 * tested_entries(tab[0], tab[1])),
        (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS) * tested_slots(tab[0], tab[1])))
    srt = PC.sort_and_ranges(ek[:2], plan, tiles_x * tiles_y)
    ent = (srt.key, tab[4], srt.idx_bits)
    frame_kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=W, height=H, **bkw)
    out, ms = device_ms(torch, lambda: KB.blend_image_cuda(
        *ent, srt.starts, srt.counts, **frame_kw), 10)
    if not (torch.equal(out[0], fr["out"].color)
            and torch.equal(out[1], fr["out"].depth)):
        raise RuntimeError(f"tiles {tag}: staged frame differs from the "
                           "frame function's")
    plain_ms, processed = blend_rows_check(
        torch, KB, f"blend.{tag}", ent, srt.starts, srt.counts, out, {},
        tiles_x=tiles_x, tiles_y=tiles_y, width=W, height=H, tile_w=tw,
        tile_h=th)
    rows.append(kernel_row(
        f"blend.{tag}", "blend", launches["blend"], ms, plain_ms, 0.0,
        blend_bytes(torch, KB, ent, srt.starts, processed, 4, W * H),
        blend_flops(torch, KB, ent, srt.starts, processed, tiles_x=tiles_x,
                    tile_w=tw, tile_h=th)[0]))
    log(f"[tiles] {tag}: " + json.dumps(dict(
        rows=int(off[n]), row_capacity=r_cap, slots=int(ek[2]), capacity=cap,
        live=int(srt.counts.sum()), records_composited=float(processed.sum()),
        max_tile_count=int(srt.counts.max()))))
    return rows


def stereo_tile_rows(torch, T, hl, st, tile, fr, fov=None, no_cutoff=False):
    """The kernels of the stereo frame (or, with ``fov`` = (target, tables),
    the foveated frame) at ``tile`` on its own tensors, each bit-equal to
    its plain version, the staged frame bit-equal to the frame function's;
    their kernel rows: the dual-eye projection, prep and the expand in
    mode "stereo" or "warped" (with the bounds gather), the dual-eye
    blend (with pixel coordinates); with ``no_cutoff`` also the dual-eye
    blend without a cutoff on the same tensors (no frame launches it: its
    row's launches are 0)."""
    import numpy as np
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD

    tw, th = tile
    tag = f"{tw}x{th}"
    kind = "stereo" if fov is None else "warped"
    n, cam, cfg, launches = hl["n"], hl["cam"], hl["cfg"], fr["launches"]
    comp, harm = KP.cached_projection_inputs(hl["gi"], 3)
    views, projs, centers, stm = PD._stereo_rig(st["stereo"])
    pw, ph = (W, H) if fov is None else (fov[0].render_width,
                                         fov[0].render_height)
    tiles_x, tiles_y = -(-pw // tw), -(-ph // th)
    plan = OB.make_key_plan(tiles_x * tiles_y, n, near_plane=cam.near_plane,
                            far_plane=cam.far_plane)
    pkw = dict(width=W, height=H, tile_w=tw, tile_h=th, sh_degree=3,
               near_plane=cam.near_plane, far_plane=cam.far_plane,
               alpha_threshold=cfg.alpha_threshold,
               total_ink_threshold=cfg.total_ink_threshold,
               input_is_srgb=False, key_plan=plan)
    sargs = (comp, harm, views, projs, centers, stm)
    rows = []
    sk, ms, sp, plain_ms = timed_pair(
        torch, "stereo_project", lambda: KP.stereo_project_cuda(*sargs, **pkw),
        lambda: KP.stereo_project_plain(*sargs, **pkw))
    require_exact(torch, f"stereo_project.{tag}", [
        (sk.rect_word, sp.rect_word), (sk.rect_h, sp.rect_h), (sk.dsw, sp.dsw),
        (sk.visible, sp.visible)] + list(zip(sk.words, sp.words)))
    ferr = max(float((getattr(sk, f) - getattr(sp, f)).abs().max())
               for f in ("px_min", "px_max", "py_min", "py_max"))
    if ferr > 1e-3:
        raise RuntimeError(f"stereo_project.{tag}: pixel bounds max |d| {ferr}")
    # a stereo frame's row stands for the foveated frame's at its tile
    if fov is None or tile not in TILE_STEREO + (ODD_TILE,):
        rows.append(kernel_row(
            f"stereo_project.{tag}", "stereo_project",
            launches["stereo_project"], ms, plain_ms, ferr,
            (11 + harm.shape[0]) * 4 * n + (10 * 4 + 4 * 4 + 1) * n,
            STEREO_PROJECT_FLOPS * n))
    bkw = dict(tile_w=tw, tile_h=th)
    prep_kw = dict(mode=kind, **bkw)
    packed, bound_bytes, coords = sk, 0, None
    if fov is not None:
        target, tables = fov
        bounds = tables["bounds"]
        packed, _ = PD.foveated_packed(sk, tables["inv_fit"], tiles_x=tiles_x,
                                       tiles_y=tiles_y, **bkw)
        fru = packed.rect_word.long() & 0xFFFFFFFF
        mtx, mty = (fru & 0x3FF).int(), ((fru >> 10) & 0x3FF).int()
        (gfx, gfy), ms, (pfx, pfy), plain_ms = timed_pair(
            torch, "bounds_gather",
            lambda: KE.warped_bounds_gather_cuda(bounds, mtx, mty),
            lambda: KE.warped_bounds_gather_plain(bounds, mtx, mty),
            reps=20, plain_reps=3)
        for a, b in zip(gfx + gfy, pfx + pfy):
            if not torch.equal(a, b):
                raise RuntimeError(f"bounds_gather.{tag}: kernel differs "
                                   "from plain")
        # the gathered boundaries feed this tile's display rects
        rows.append(kernel_row(
            f"bounds_gather.{tag}", "bounds_gather",
            launches["bounds_gather"], ms, plain_ms, 0.0,
            2 * 128 * 4 + 2 * 4 * n + 14 * 4 * n, 0.0))
        prep_kw.update(warped_bounds=bounds, lod_min=cfg.foveated_lod)
        bound_bytes = 2 * 128 * 4
        coords = (tables["coord_x"], tables["coord_y"])
    prep_in = (packed.rect_word, packed.rect_h, packed.words)
    (off, rect, mask), ms, prep_p, plain_ms = timed_pair(
        torch, "prep", lambda: KE.binning_prep_cuda(*prep_in, **prep_kw),
        lambda: KE.binning_prep_plain(*prep_in, **prep_kw))
    require_exact(torch, f"prep.{kind}.{tag}",
                  list(zip((off, rect, mask), prep_p)))
    lod_word = fov is not None and cfg.foveated_lod > 0
    rows.append(kernel_row(
        f"prep.{kind}.{tag}", "prep", launches["prep"], ms, plain_ms, 0.0,
        (2 + 6 + lod_word + 3) * 4 * n + 4 + bound_bytes,
        2 * PREP_DECODE_FLOPS * n
        + 2 * TILE_TEST_FLOPS * tile_tests(packed.rect_word, packed.rect_h)))
    cap = fr["cap"]
    ekw = dict(capacity=cap, tiles_x=tiles_x, key_plan=plan, mode=kind, **bkw)
    if fov is not None:
        ekw["warped_bounds"] = bounds
    exp_in = (off, rect, mask, packed.dsw, packed.words)
    ek, ms, ep, plain_ms = timed_pair(
        torch, "expand", lambda: KE.expand_slots_cuda(*exp_in, **ekw),
        lambda: KE.expand_slots_plain(*exp_in, **ekw))
    require_exact(torch, f"expand.{kind}.{tag}", list(zip(ek, ep)))
    warped = fov is not None
    rows.append(kernel_row(
        f"expand.{kind}.{tag}", "expand", launches["expand"], ms, plain_ms,
        0.0, expand_bytes(n, cap, 6 * tested_entries(off, rect, warped))
        + bound_bytes,
        (2 * EXPAND_DECODE_FLOPS + 2 * TILE_TEST_FLOPS)
        * tested_slots(off, rect, warped)))
    srt = PC.sort_and_ranges(ek[:2], plan, tiles_x * tiles_y)
    ent = (srt.key, packed.words, srt.idx_bits)
    frame_kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=pw, height=ph,
                    n_eyes=2, r2_cutoff=9.0, pixel_coords=coords, **bkw)
    out, ms = device_ms(torch, lambda: KB.blend_image_cuda(
        *ent, srt.starts, srt.counts, **frame_kw), 10)
    if not (torch.equal(out[0], fr["out"].color)
            and torch.equal(out[1], fr["out"].depth)):
        raise RuntimeError(f"{kind} {tag}: staged frame differs from the "
                           "frame function's")
    plain_ms, processed = blend_rows_check(
        torch, KB, f"blend.{kind}.{tag}", ent, srt.starts, srt.counts, out,
        dict(r2_cutoff=9.0, pixel_coords=coords), tiles_x=tiles_x,
        tiles_y=tiles_y, width=pw, height=ph, tile_w=tw, tile_h=th, n_eyes=2)
    flops, inside, pairs = blend_flops(
        torch, KB, ent, srt.starts, processed, tiles_x=tiles_x, n_eyes=2,
        r2_cutoff=9.0, pixel_coords=coords, tile_w=tw, tile_h=th)
    rows.append(kernel_row(
        f"blend.{kind}.{tag}", "blend", launches["blend"], ms, plain_ms, 0.0,
        blend_bytes(torch, KB, ent, srt.starts, processed, 7, 2 * pw * ph)
        + (0 if coords is None else (tiles_x + tiles_y) * tw * th * 4), flops))
    if no_cutoff:
        name = f"blend.{kind}_no_cutoff.{tag}"
        kw0 = dict(frame_kw, r2_cutoff=0.0)
        out0, ms = device_ms(torch, lambda: KB.blend_image_cuda(
            *ent, srt.starts, srt.counts, **kw0), 10)
        plain_ms, done = blend_rows_check(
            torch, KB, name, ent, srt.starts, srt.counts, out0,
            dict(r2_cutoff=0.0, pixel_coords=coords), tiles_x=tiles_x,
            tiles_y=tiles_y, width=pw, height=ph, tile_w=tw, tile_h=th,
            n_eyes=2)
        rows.append(kernel_row(
            name, "blend", 0, ms, plain_ms, 0.0,
            blend_bytes(torch, KB, ent, srt.starts, done, 7, 2 * pw * ph)
            + (0 if coords is None else (tiles_x + tiles_y) * tw * th * 4),
            blend_flops(torch, KB, ent, srt.starts, done, tiles_x=tiles_x,
                        n_eyes=2, pixel_coords=coords, tile_w=tw,
                        tile_h=th)[0]))
    log(f"[tiles] {kind} {tag}: " + json.dumps(dict(
        slots=int(ek[2]), capacity=cap, live=int(srt.counts.sum()),
        records_composited=float(processed.sum()), pairs_within_cutoff=inside,
        pairs=pairs, tiles=[tiles_x, tiles_y])))
    return rows


def full_rect_rows(torch, T, hl, hwf, glf, tile=(32, 16)):
    """The full-rect frames at ``tile`` on their own tensors: (``hwf`` not
    None) the Hardware frame's prep and expand in mode "none" and its
    one-eye cutoff blend with normalized depth, and (``glf`` not None) the
    Global frame's expand in mode "none" over the d16 KeyPlan (and prep
    "none" where no Hardware frame runs); each bit-equal to its plain
    version, the staged frames bit-equal to the frame functions'; their
    kernel rows."""
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC

    n, cam, cfg = hl["n"], hl["cam"], hl["cfg"]
    tw, th = tile
    tag = f"{tw}x{th}"
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    comp, harm = KP.cached_projection_inputs(hl["gi"], 3)
    args = (comp, harm, cam.view_matrix, cam.projection_matrix, cam.position)
    pkw = dict(width=W, height=H, tile_w=tw, tile_h=th, sh_degree=3,
               near_plane=cam.near_plane, far_plane=cam.far_plane,
               alpha_threshold=cfg.alpha_threshold,
               total_ink_threshold=cfg.total_ink_threshold,
               input_is_srgb=False)
    bkw = dict(tile_w=tw, tile_h=th)
    rows = []
    plan = OB.make_key_plan(tiles_x * tiles_y, n, near_plane=cam.near_plane,
                            far_plane=cam.far_plane)
    pk = KP.project_cuda(*args, key_plan=plan, **pkw)
    prep_in = (pk.rect_word, pk.rect_h, pk.words)
    (off, rect, mask), ms, (off_p, _r, _m), plain_ms = timed_pair(
        torch, "prep", lambda: KE.binning_prep_cuda(*prep_in, mode="none",
                                                    **bkw),
        lambda: KE.binning_prep_plain(*prep_in, mode="none", **bkw))
    require_exact(torch, f"prep.none.{tag}", [(off, off_p)])
    rows.append(kernel_row(f"prep.none.{tag}", "prep",
                           (hwf or glf)["launches"]["prep"], ms, plain_ms,
                           0.0, 3 * 4 * n + 4, 0.0))
    full = [] if hwf is None else [(f"expand.none.{tag}", hwf, plan, pk.words,
                                    pk.dsw)]
    if glf is not None:
        # the Global frame's own tile keeps the name of phase 4t's row
        full.append(("expand.none.d16_32" if tile == (32, 16)
                     else f"expand.none.d16.{tag}", glf, None, None, None))
    for label, fr, p, words, dsw in full:
        if p is None:  # the Global frame: the half-depth key, its plan
            dk = KP.project_cuda(*args, key_plan=None, depth_key16=True, **pkw)
            p = PC.d16_key_plan(tiles_x * tiles_y, n)
            words, dsw = dk.words, dk.dsw
            off, rect = KE.binning_prep_cuda(dk.rect_word, dk.rect_h, words,
                                             mode="none", **bkw)[:2]
        ekw = dict(capacity=fr["cap"], tiles_x=tiles_x, key_plan=p,
                   mode="none", **bkw)
        exp_in = (off, rect, None, dsw, words)
        ek, ms, ep, plain_ms = timed_pair(
            torch, "expand", lambda: KE.expand_slots_cuda(*exp_in, **ekw),
            lambda: KE.expand_slots_plain(*exp_in, **ekw))
        require_exact(torch, label, list(zip(ek, ep)))
        rows.append(kernel_row(label, "expand", fr["launches"]["expand"], ms,
                               plain_ms, 0.0,
                               (n + 1) * 4 + 2 * 4 * n + 2 * 4 * fr["cap"],
                               0.0))
        srt = PC.sort_and_ranges(ek[:2], p, tiles_x * tiles_y)
        ent = (srt.key, words, srt.idx_bits)
        hw = fr is hwf
        blend_kw = dict(r2_cutoff=9.0, depth_mode="normalized") if hw else {}
        frame_kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=W, height=H,
                        **blend_kw, **bkw)
        out, ms = device_ms(torch, lambda: KB.blend_image_cuda(
            *ent, srt.starts, srt.counts, **frame_kw), 10)
        if not (torch.equal(out[0], fr["out"].color)
                and torch.equal(out[1], fr["out"].depth)):
            raise RuntimeError(f"{label}: staged frame differs from the frame "
                               "function's")
        if hw:
            plain_ms, processed = blend_rows_check(
                torch, KB, f"blend.cutoff_normalized.{tag}", ent, srt.starts,
                srt.counts, out, blend_kw, tiles_x=tiles_x, tiles_y=tiles_y,
                width=W, height=H, tile_w=tw, tile_h=th)
            flops = blend_flops(
                torch, KB, ent, srt.starts, processed, tiles_x=tiles_x,
                r2_cutoff=9.0, tile_w=tw, tile_h=th)[0]
            rows.append(kernel_row(
                f"blend.cutoff_normalized.{tag}", "blend",
                fr["launches"]["blend"], ms, plain_ms, 0.0,
                blend_bytes(torch, KB, ent, srt.starts, processed, 4, W * H),
                flops))
    return rows


def mono_tile_frame(torch, T, kernels, hl, tile):
    """The mono frame function with rows at ``tile`` on the headline scene
    (rows off where no KeyPlan addresses them): its capacities probed from
    its slot and row totals, a frame loop with launch counts of its own
    (:func:`fixed_frame_loop`), the rows-on frame bit-equal to rows off,
    then :func:`mono_tile_rows`.  Returns (stats,
    kernel rows, the rows-off frame and its capacity)."""
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD

    gi, cam, n, cfg = hl["gi"], hl["cam"], hl["n"], hl["cfg"]
    tag = f"{tile[0]}x{tile[1]}"
    kw = dict(sh_degree=3, alpha_threshold=cfg.alpha_threshold,
              total_ink_threshold=cfg.total_ink_threshold,
              near_plane=cam.near_plane, far_plane=cam.far_plane,
              input_is_srgb=False, width=W, height=H, tile_w=tile[0],
              tile_h=tile[1])
    view = (cam.view_matrix, cam.projection_matrix, cam.position)
    prepared = cached_projection_inputs(gi, 3)
    run = lambda cap, rc=0: PD.depth_first_frame(
        gi, *view, prepared, capacity=cap, row_capacity=rc, **kw)
    probe = run(TILE_PROBE_SLOTS * -(-n // 4096) * 4096)
    cap_off = fit_capacity(int(probe.header.slot_total))
    row_cap = 1 << (2 * int(probe.header.row_total) - 1).bit_length()
    # where no KeyPlan addresses the rows (7x5: 59,400 tiles), the frame
    # function runs rows off, as JAX's does
    if PD._mono_key_statics(n, row_capacity=row_cap, width=W, height=H,
                            tile_w=tile[0], tile_h=tile[1],
                            near_plane=cam.near_plane,
                            far_plane=cam.far_plane) is None:
        row_cap = 0
    cap = fit_capacity(int(run(cap_off, row_cap).header.slot_total))
    out, stats, launches = fixed_frame_loop(
        torch, kernels, MONO_ROWS_PATH if row_cap else MONO_RECTS_PATH,
        f"tiles {tag}", lambda: run(cap, row_cap))
    off = run(cap_off)
    if not (torch.equal(out.color, off.color)
            and torch.equal(out.depth, off.depth)):
        raise RuntimeError(f"tiles {tag}: rows-on frame differs from rows off")
    stats.update(capacity=cap, row_capacity=row_cap,
                 rows_off_slot_total=int(off.header.slot_total))
    fr = dict(out=out, cap=cap, row_cap=row_cap, launches=launches)
    return (stats, mono_tile_rows(torch, T, hl, tile, fr),
            dict(off=off, cap_off=cap_off))


def frame_statics(hl, tile) -> dict:
    """The frame functions' keywords on the headline scene at ``tile``."""
    cam, cfg = hl["cam"], hl["cfg"]
    return dict(sh_degree=3, alpha_threshold=cfg.alpha_threshold,
                total_ink_threshold=cfg.total_ink_threshold,
                near_plane=cam.near_plane, far_plane=cam.far_plane,
                input_is_srgb=False, tile_w=tile[0], tile_h=tile[1])


def stereo_tile_frame(torch, T, kernels, hl, st, tile, fv=None,
                      no_cutoff=False):
    """The stereo frame function at ``tile`` on the headline scene and rig
    (or, with ``fv`` phase 4f's result, the foveated frame at that tile): a
    frame loop at a probed capacity with launch counts of its own, then
    :func:`stereo_tile_rows`.  Returns (stats, kernel rows)."""
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD

    gi, n, cfg = hl["gi"], hl["n"], hl["cfg"]
    tag = f"{tile[0]}x{tile[1]}"
    prepared = cached_projection_inputs(gi, 3)
    rig = PD._stereo_rig(st["stereo"])
    kw = frame_statics(hl, tile)
    fov = None
    if fv is None:
        label, path, split_frames = f"stereo {tag}", STEREO_PATH, 5
        run = lambda cap: PD.depth_first_stereo_frame(
            gi, *rig, prepared, capacity=cap, width=W, height=H, **kw)
    else:
        label, path, split_frames = f"foveated {tag}", FOVEATED_PATH, 2
        target = fv["target"]
        tables = PD.foveated_device_tables(target, gi.positions.device, *tile)
        fov = (target, tables)
        run = lambda cap: PD.depth_first_stereo_foveated_frame(
            gi, *rig, tables, prepared, capacity=cap, display_width=W,
            display_height=H, render_width=target.render_width,
            render_height=target.render_height,
            foveated_lod=cfg.foveated_lod, **kw)
    cap = probed_capacity(run, n)
    out, stats, launches = fixed_frame_loop(
        torch, kernels, path, label, lambda: run(cap), halves=2,
        split_frames=split_frames)
    stats["capacity"] = cap
    return stats, stereo_tile_rows(
        torch, T, hl, st, tile, dict(out=out, cap=cap, launches=launches),
        fov=fov, no_cutoff=no_cutoff)


def full_rect_frames(torch, T, kernels, hl, tile, with_global,
                     with_hardware=True):
    """The Hardware frame function at ``tile`` (unless not
    ``with_hardware``; and, ``with_global``,
    ``global_frame(exact_tile_test=False)``) on the headline scene: frame
    loops at probed capacities with launch counts of their own, then
    :func:`full_rect_rows`.  Returns (stats by frame, kernel rows)."""
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
    from gsm_renderer_tpu_torch.pipelines.hardware import hardware_frame

    gi, cam, n = hl["gi"], hl["cam"], hl["n"]
    prepared = cached_projection_inputs(gi, 3)
    view = (cam.view_matrix, cam.projection_matrix, cam.position)
    kw = dict(frame_statics(hl, tile), width=W, height=H)
    tag = f"{tile[0]}x{tile[1]}"
    runs = []
    if with_hardware:
        runs.append((f"hardware_{tag}", lambda cap: hardware_frame(
            gi, *view, prepared, capacity=cap, **kw)))
    if with_global:
        runs.append(("global_no_exact_test", lambda cap: global_frame(
            gi, *view, prepared, capacity=cap, exact_tile_test=False, **kw)))
    frames, full = {}, {}
    for label, run in runs:
        cap = probed_capacity(run, n)
        out, stats, launches = fixed_frame_loop(
            torch, kernels, HARDWARE_PATH, label,
            lambda cap=cap, run=run: run(cap))
        stats["capacity"] = cap
        frames[label] = stats
        full[label] = dict(out=out, cap=cap, launches=launches)
    return frames, full_rect_rows(torch, T, hl, full.get(f"hardware_{tag}"),
                                  full.get("global_no_exact_test"), tile)


def phase_tiles(torch, T, kernels, hl, st, fv, real):
    """Phase 4t: the frame functions at other tiles and frame options, at
    full width on the headline scene: the mono frame with rows at every
    TILE_MONO tile (bit-equal to rows off), the stereo frame at the
    TILE_STEREO tiles, the foveated frame at the TILE_FOVEATED tiles, the
    Hardware frame and ``global_frame(exact_tile_test=False)`` at 32x16,
    and ``depth_first_frame(max_per_tile=2048)`` on the realistic scene
    (``real``), where tiles clamp.  Each frame at a capacity probed from
    its slot total, with launch counts of its own, the frame gate, its
    split and trace; then each kernel mode on its tensors against its
    plain version.  Returns (kernel rows, the 8x8 frames for phase 4m)."""
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD

    t0 = time.perf_counter()
    n, cfg = hl["n"], hl["cfg"]
    statics = dict(sh_degree=3, alpha_threshold=cfg.alpha_threshold,
                   total_ink_threshold=cfg.total_ink_threshold,
                   input_is_srgb=False)
    frames, rows, tiles8 = {}, [], None

    for tile in TILE_MONO:
        stats, mono_rows, off = mono_tile_frame(torch, T, kernels, hl, tile)
        frames[f"mono_{tile[0]}x{tile[1]}"] = stats
        rows += mono_rows
        if tile == (8, 8):
            tiles8 = off

    for tile in TILE_STEREO:
        stats, stereo_rows = stereo_tile_frame(torch, T, kernels, hl, st, tile)
        frames[f"stereo_{tile[0]}x{tile[1]}"] = stats
        rows += stereo_rows
    for tile in TILE_FOVEATED:
        stats, fov_rows = stereo_tile_frame(torch, T, kernels, hl, st, tile,
                                            fv=fv)
        frames[f"foveated_{tile[0]}x{tile[1]}"] = stats
        rows += fov_rows
    full, full_rows = full_rect_frames(torch, T, kernels, hl, (32, 16),
                                       with_global=True)
    frames.update(full)
    rows += full_rows

    rgi, rcam = real["gi"], real["cam"]
    rkw = dict(statics, width=W, height=H, near_plane=rcam.near_plane,
               far_plane=rcam.far_plane)
    rview = (rcam.view_matrix, rcam.projection_matrix, rcam.position)
    rprep = cached_projection_inputs(rgi, 3)
    run = lambda cap, mpt=TILE_MAX_PER_TILE: PD.depth_first_frame(
        rgi, *rview, rprep, capacity=cap, max_per_tile=mpt, **rkw)
    cap = probed_capacity(run, n)
    label = f"max_per_tile {TILE_MAX_PER_TILE}"
    out, stats, launches = fixed_frame_loop(
        torch, kernels, MONO_RECTS_PATH, label, lambda: run(cap))
    full_frame = run(cap, 0)
    tiles_x, tiles_y = -(-W // 16), -(-H // 16)
    srt = PC.mono_packed_sorted(
        rgi, *rview, rprep, key_plan=OB.make_key_plan(
            tiles_x * tiles_y, rgi.count, near_plane=rcam.near_plane,
            far_plane=rcam.far_plane), capacity=cap, tiles_x=tiles_x,
        tiles_y=tiles_y, tile_w=16, tile_h=16, **rkw)[0]
    clamped_tiles = torch.nonzero(srt.counts > TILE_MAX_PER_TILE).flatten()
    clamped = int(clamped_tiles.numel())
    keep = ~tile_pixels(torch, clamped_tiles, tiles_x, 16, rgi.positions.device)
    if clamped == 0:
        raise RuntimeError(f"{label}: no tile clamped")
    if not torch.equal(out.color[keep], full_frame.color[keep]):
        raise RuntimeError(f"{label}: the frame differs from the unclamped "
                           "frame on tiles the clamp leaves alone")
    if int(out.header.slot_total) != int(full_frame.header.slot_total):
        raise RuntimeError(f"{label}: the clamp moved slot_total")
    # a clamped tile whose pixels saturate within the clamp keeps its
    # image; a clamp at 64 records changes the frame
    if torch.equal(run(cap, 64).color, full_frame.color):
        raise RuntimeError(f"{label}: a clamp at 64 left the frame unchanged")
    stats.update(capacity=cap, clamped_tiles=clamped,
                 max_tile_count=int(srt.counts.max()),
                 pixels_differ=int((out.color != full_frame.color).any(-1)
                                   .sum()),
                 unclamped_total_instances=int(full_frame.header.total_instances))
    frames[label.replace(" ", "_")] = stats
    log("[tiles] " + json.dumps({"tile_frames": frames,
                                 "seconds": time.perf_counter() - t0}))
    return rows, tiles8


def d16_tile_rows(torch, T, hl, tile, fr, local):
    """The kernels of the Global frame (``local``: the Local frame) at
    ``tile`` on its own tensors: the projection with the half-depth key,
    prep and the expand over the d16 KeyPlan, and the blend (weighted
    depth; Local: first_hit depth over counts clamped at its
    ``max_per_tile``), each bit-equal to its plain version, the staged
    frame bit-equal to the frame function's; their kernel rows."""
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.pipelines import common as PC

    tw, th = tile
    tag = f"{tw}x{th}"
    n, cam, cfg, launches = hl["n"], hl["cam"], hl["cfg"], fr["launches"]
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    comp, harm = KP.cached_projection_inputs(hl["gi"], 3)
    args = (comp, harm, cam.view_matrix, cam.projection_matrix, cam.position)
    pkw = dict(width=W, height=H, tile_w=tw, tile_h=th, sh_degree=3,
               near_plane=cam.near_plane, far_plane=cam.far_plane,
               alpha_threshold=cfg.alpha_threshold,
               total_ink_threshold=cfg.total_ink_threshold,
               input_is_srgb=False, key_plan=None, depth_key16=True)
    rows = []
    dk, ms, dp, plain_ms = timed_pair(
        torch, "project", lambda: KP.project_cuda(*args, **pkw),
        lambda: KP.project_plain(*args, **pkw))
    require_exact(torch, f"project.d16.{tag}", [
        (dk.rect_word, dp.rect_word), (dk.rect_h, dp.rect_h),
        (dk.dsw, dp.dsw), (dk.visible, dp.visible)]
        + list(zip(dk.words, dp.words)))
    rows.append(kernel_row(f"project.d16.{tag}", "project",
                           launches["project"], ms, plain_ms, 0.0,
                           (11 + harm.shape[0]) * 4 * n + (7 * 4 + 1) * n,
                           PROJECT_FLOPS * n))
    bkw = dict(tile_w=tw, tile_h=th)
    prep_in = (dk.rect_word, dk.rect_h, dk.words)
    (off, rect, mask), ms, prep_p, plain_ms = timed_pair(
        torch, "prep", lambda: KE.binning_prep_cuda(*prep_in, **bkw),
        lambda: KE.binning_prep_plain(*prep_in, **bkw))
    require_exact(torch, f"prep.d16.{tag}", list(zip((off, rect, mask),
                                                     prep_p)))
    rows.append(kernel_row(
        f"prep.d16.{tag}", "prep", launches["prep"], ms, plain_ms, 0.0,
        (6 + 3) * 4 * n + 4,
        PREP_DECODE_FLOPS * n + TILE_TEST_FLOPS * tile_tests(dk.rect_word,
                                                             dk.rect_h)))
    plan = PC.d16_key_plan(tiles_x * tiles_y, n)
    ekw = dict(capacity=fr["cap"], tiles_x=tiles_x, key_plan=plan, **bkw)
    exp_in = (off, rect, mask, dk.dsw, dk.words)
    ek, ms, ep, plain_ms = timed_pair(
        torch, "expand", lambda: KE.expand_slots_cuda(*exp_in, **ekw),
        lambda: KE.expand_slots_plain(*exp_in, **ekw))
    require_exact(torch, f"expand.d16.{tag}", list(zip(ek, ep)))
    rows.append(kernel_row(
        f"expand.d16.{tag}", "expand", launches["expand"], ms, plain_ms, 0.0,
        expand_bytes(n, fr["cap"], 4 * tested_entries(off, rect)),
        (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS) * tested_slots(off, rect)))
    srt = PC.sort_and_ranges(ek[:2], plan, tiles_x * tiles_y)
    counts = srt.counts
    if local:
        counts = torch.clamp(counts, max=T.config.LOCAL_MAX_PER_TILE)
    mode = "first_hit" if local else "weighted"
    name = f"blend.{'first_hit' if local else 'global'}.{tag}"
    ent = (srt.key, dk.words, srt.idx_bits)
    frame_kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=W, height=H,
                    depth_mode=mode, **bkw)
    out, ms = device_ms(torch, lambda: KB.blend_image_cuda(
        *ent, srt.starts, counts, **frame_kw), 10)
    if not (torch.equal(out[0], fr["out"].color)
            and torch.equal(out[1], fr["out"].depth)):
        raise RuntimeError(f"{name}: staged frame differs from the frame "
                           "function's")
    plain_ms, processed = blend_rows_check(
        torch, KB, name, ent, srt.starts, counts, out, dict(depth_mode=mode),
        tiles_x=tiles_x, tiles_y=tiles_y, width=W, height=H, tile_w=tw,
        tile_h=th)
    rows.append(kernel_row(
        name, "blend", launches["blend"], ms, plain_ms, 0.0,
        blend_bytes(torch, KB, ent, srt.starts, processed, 4, W * H),
        blend_flops(torch, KB, ent, srt.starts, processed, tiles_x=tiles_x,
                    tile_w=tw, tile_h=th)[0]))
    return rows


def d16_tile_frame(torch, T, kernels, hl, tile, local):
    """``global_frame`` (``local``: ``local_frame``) at ``tile`` on the
    headline scene: a frame loop at a probed capacity with launch counts of
    its own, then :func:`d16_tile_rows`.  Returns (stats, kernel rows)."""
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
    from gsm_renderer_tpu_torch.pipelines.local import local_frame

    gi, cam, n = hl["gi"], hl["cam"], hl["n"]
    prepared = cached_projection_inputs(gi, 3)
    view = (cam.view_matrix, cam.projection_matrix, cam.position)
    kw = dict(frame_statics(hl, tile), width=W, height=H)
    frame = local_frame if local else global_frame
    run = lambda cap: frame(gi, *view, prepared, capacity=cap, **kw)
    cap = probed_capacity(run, n)
    label = f"{'local' if local else 'global'} {tile[0]}x{tile[1]}"
    out, stats, launches = fixed_frame_loop(torch, kernels, MONO_RECTS_PATH,
                                            label, lambda: run(cap))
    stats["capacity"] = cap
    return stats, d16_tile_rows(torch, T, hl, tile,
                                dict(out=out, cap=cap, launches=launches),
                                local)


def phase_odd_tiles(torch, T, kernels, hl, st, fv):
    """Phase 4o: the frame functions at tile sides that are not powers of
    two, at full width on the headline scene: the mono frame with rows at
    every ODD_MONO tile (bit-equal to rows off; 64x64 takes the blend's
    cluster of eight CTAs), the stereo frame at ODD_TILE with the two-eye
    blend without a cutoff on its tensors, the foveated, Hardware and
    Local frames at ODD_TILE, and the Global frame at ODD_GLOBAL.  Each
    frame at a capacity probed from its slot total, with launch counts of
    its own, the frame gate, its split and trace; then each kernel mode on
    its tensors against its plain version.  Returns (kernel rows, the
    ODD_TILE rows-off frame for phase 4m)."""
    t0 = time.perf_counter()
    frames, rows, odd = {}, [], None
    for tile in ODD_MONO:
        stats, mono_rows, off = mono_tile_frame(torch, T, kernels, hl, tile)
        frames[f"mono_{tile[0]}x{tile[1]}"] = stats
        rows += mono_rows
        if tile == ODD_TILE:
            odd = off
    tag = f"{ODD_TILE[0]}x{ODD_TILE[1]}"
    stats, more = stereo_tile_frame(torch, T, kernels, hl, st, ODD_TILE,
                                    no_cutoff=True)
    frames[f"stereo_{tag}"] = stats
    rows += more
    stats, more = stereo_tile_frame(torch, T, kernels, hl, st, ODD_TILE, fv=fv)
    frames[f"foveated_{tag}"] = stats
    rows += more
    full, more = full_rect_frames(torch, T, kernels, hl, ODD_TILE,
                                  with_global=False)
    frames.update(full)
    rows += more
    for tile, local in ((ODD_TILE, True), (ODD_GLOBAL, False)):
        stats, more = d16_tile_frame(torch, T, kernels, hl, tile, local)
        frames[f"{'local' if local else 'global'}_{tile[0]}x{tile[1]}"] = stats
        rows += more
    log("[odd tiles] " + json.dumps({"tile_frames": frames,
                                     "seconds": time.perf_counter() - t0}))
    return rows, odd


def phase_large_tiles(torch, T, kernels, hl, st, fv):
    """Phase 4L: the frame functions at tile sides over 64 pixels, at full
    width on the headline scene: the mono frame with rows at every
    LARGE_MONO tile (bit-equal to rows off; 65x65 is the smallest tile on
    the blend's large-tile path), the stereo frame at LARGE_STEREO with the
    two-eye blend without a cutoff on its tensors, the foveated and
    Hardware frames at LARGE_TILE, the Local frame at LARGE_STEREO and the
    Global frame at LARGE_GLOBAL with and without the exact tile test.
    Each frame at a capacity probed from its slot total, with launch counts
    of its own, the frame gate, its split and trace; then each kernel mode
    on its tensors against its plain version.  Returns (kernel rows, the
    LARGE_TILE rows-off frame for phase 4m)."""
    t0 = time.perf_counter()
    frames, rows, large = {}, [], None
    for tile in LARGE_MONO:
        stats, mono_rows, off = mono_tile_frame(torch, T, kernels, hl, tile)
        frames[f"mono_{tile[0]}x{tile[1]}"] = stats
        rows += mono_rows
        if tile == LARGE_TILE:
            large = off
    tag = f"{LARGE_STEREO[0]}x{LARGE_STEREO[1]}"
    stats, more = stereo_tile_frame(torch, T, kernels, hl, st, LARGE_STEREO,
                                    no_cutoff=True)
    frames[f"stereo_{tag}"] = stats
    rows += more
    stats, more = stereo_tile_frame(torch, T, kernels, hl, st, LARGE_TILE,
                                    fv=fv)
    frames[f"foveated_{LARGE_TILE[0]}x{LARGE_TILE[1]}"] = stats
    rows += more
    for tile, hardware in ((LARGE_TILE, True), (LARGE_GLOBAL, False)):
        full, more = full_rect_frames(torch, T, kernels, hl, tile,
                                      with_global=not hardware,
                                      with_hardware=hardware)
        frames.update({f"{k}_{tile[0]}x{tile[1]}" if "global" in k else k: v
                       for k, v in full.items()})
        rows += more
    for tile, local in ((LARGE_STEREO, True), (LARGE_GLOBAL, False)):
        stats, more = d16_tile_frame(torch, T, kernels, hl, tile, local)
        frames[f"{'local' if local else 'global'}_{tile[0]}x{tile[1]}"] = stats
        rows += more
    log("[large tiles] " + json.dumps({"tile_frames": frames,
                                       "seconds": time.perf_counter() - t0}))
    return rows, large


def phase_kernels(torch, T, hl, st, fv, d16, hw):
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD
    import numpy as np

    n, w, h, cam, cfg = hl["n"], hl["w"], hl["h"], hl["cam"], hl["cfg"]
    tiles_x, tiles_y = -(-w // 16), -(-h // 16)
    comp, harm = KP.cached_projection_inputs(hl["gi"], 3)
    r_cap = hl["row_capacity"]
    plan = OB.make_key_plan(tiles_x * tiles_y, r_cap, near_plane=cam.near_plane,
                            far_plane=cam.far_plane)
    pkw = dict(width=w, height=h, tile_w=16, tile_h=16, sh_degree=3,
               near_plane=cam.near_plane, far_plane=cam.far_plane,
               alpha_threshold=cfg.alpha_threshold,
               total_ink_threshold=cfg.total_ink_threshold,
               input_is_srgb=False, key_plan=plan)
    args = (comp, harm, cam.view_matrix, cam.projection_matrix, cam.position)
    rows, other = {}, []
    n_coeffs = harm.shape[0]

    def record(name, kernel, launches, ms, plain_ms, err, flips, nbytes, flops):
        b, by = bound(nbytes, flops)
        src, replaces = KERNEL_SOURCES[kernel]
        rows[name] = dict(name=name, route="cuda", source=src,
                          replaces=replaces, launches=launches,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by, library_ms=None,
                          flips=flips)
        log(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b:.4f} ms by {by}), max_abs_err {err}, flips {flips}")

    def check_exact(name, pairs):
        bad, total, worst = mismatches(torch, pairs)
        if bad:
            raise RuntimeError(f"{name}: {bad} of {total} outputs differ "
                               f"(max |d| {worst})")
        return 0.0, 0.0

    def tile_key_order(name, exp_in, ekw, ref_keys, plan, num_tiles):
        # the stable fallback's plain tile key on the same table: bit-equal
        # to its plain version, and sorted stably into the KeyPlan's order
        kw = dict(ekw, key_plan=None)
        tk = KE.expand_slots_cuda(*exp_in, **kw)
        check_exact(f"{name} tile key", list(zip(
            tk, KE.expand_slots_plain(*exp_in, **kw))))
        srt_u = PC.sort_and_ranges(ref_keys[:2], plan, num_tiles)
        srt_s = PC.sort_and_ranges(tk[:3], None, num_tiles)
        live = int(srt_u.counts.sum())
        if not (torch.equal(srt_u.starts, srt_s.starts)
                and torch.equal(KB.entry_index(srt_u.key[:live],
                                               srt_u.idx_bits),
                                srt_s.key[:live])):
            raise RuntimeError(f"{name} tile key: the stable order differs "
                               "from the KeyPlan's")
        log(f"[kernels] {name} tile key: bit-equal to its plain version; "
            f"{live} live slots sort stably into the KeyPlan order")

    mono_l, st_l = hl["launches"], st["launches"]
    timing_check = {}

    def time_check(name, fn, ms):
        # the table's time beside CUDA-event times of the same calls queued
        # as the host goes (no sleep ahead of them), then one at a time
        # after the L2 cache is overwritten, and what a torch.profiler trace
        # of 10 calls records
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        seen = device_kernel_stats(prof).values()
        timing_check[name] = dict(
            ms=ms, events_ms=cuda_ms(torch, fn, 10)[1],
            cold_events_ms=cold_cuda_ms(torch, fn, 10, comp.device),
            trace=dict(ms=sum(t for t, _ in seen) / 10,
                       launches=sum(c for _, c in seen)))

    # kernel 1: project (with the row-addressing KeyPlan of the frame)
    pk, ms = device_ms(torch, lambda: KP.project_cuda(*args, **pkw), 20)
    pp, plain_ms = cuda_ms(torch, lambda: KP.project_plain(*args, **pkw), 3)
    err, flips = check_ints(torch, "project", [
        (pk.rect_word, pp.rect_word), (pk.rect_h, pp.rect_h), (pk.dsw, pp.dsw),
        (pk.visible, pp.visible)] + list(zip(pk.words, pp.words)))
    record("project", "project", mono_l["project"], ms, plain_ms, err, flips,
           (11 + n_coeffs) * 4 * n + (7 * 4 + 1) * n, PROJECT_FLOPS * n)

    # kernel 2: prep, counting virtual rows as the rows-on frame does
    prep_in = (pk.rect_word, pk.rect_h, pk.words)
    (off, rect, mask), ms = device_ms(
        torch, lambda: KE.binning_prep_cuda(*prep_in, count_rows=True), 20)
    (off_p, rect_p, mask_p), plain_ms = cuda_ms(
        torch, lambda: KE.binning_prep_plain(*prep_in, count_rows=True), 3)
    err, flips = check_ints(torch, "prep", [(off, off_p), (rect, rect_p),
                                            (mask, mask_p)])
    record("prep", "prep", mono_l["prep"], ms, plain_ms, err, flips,
           (6 + 3) * 4 * n + 4,
           PREP_DECODE_FLOPS * n + TILE_TEST_FLOPS * tile_tests(pk.rect_word,
                                                                pk.rect_h))

    # kernel 3: row expansion over the frame's row capacity
    rkw = dict(row_capacity=r_cap)
    row_in = (off, rect, mask, pk.dsw, pk.words)
    rk, ms = device_ms(torch, lambda: KE.row_expand_cuda(*row_in, **rkw), 20)
    rp, plain_ms = cuda_ms(torch, lambda: KE.row_expand_plain(*row_in, **rkw), 3)
    err, flips = check_ints(torch, "row_expand", [
        (rk[0], rp[0]), (rk[1], rp[1]), (rk[2], rp[2]), (rk[3], rp[3]),
        (rk[5], rp[5])] + list(zip(rk[4], rp[4])))
    ru = rect.to(torch.int64) & 0xFFFFFFFF
    oversized_rows = float((off[1:] - off[:-1]).to(torch.int64)[
        ((ru >> 30) & 3) == 0].sum())
    total_rows = int(off[n])
    log(f"[kernels] row_expand: {total_rows} rows of {r_cap}, "
        f"{oversized_rows:.0f} oversized, {int(rk[0][r_cap])} slots")
    record("row_expand", "row_expand", mono_l["row_expand"], ms, plain_ms, err,
           flips, (n + 1) * 4 + 7 * 4 * n + (r_cap + 1) * 4 + 7 * 4 * r_cap,
           ROW_SPAN_FLOPS * oversized_rows)

    # kernel 4: expand over the row table
    cap = hl["capacity"]
    ekw = dict(capacity=cap, tiles_x=tiles_x, key_plan=plan)
    exp_in = (rk[0], rk[1], rk[2], rk[3], rk[4])
    ek, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*exp_in, **ekw), 20)
    ep, plain_ms = cuda_ms(torch, lambda: KE.expand_slots_plain(*exp_in, **ekw), 3)
    # key1, key2, the slot total and the overflow flag
    err, flips = check_exact("expand", list(zip(ek, ep)))
    record("expand", "expand", mono_l["expand"], ms, plain_ms, err, flips,
           expand_bytes(r_cap, cap, 4 * tested_entries(rk[0], rk[1])),
           (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS) * tested_slots(rk[0], rk[1]))

    # instance sort of the keys alone and tile ranges (library calls)
    sorted_key, sort_ms = device_ms(
        torch, lambda: PC.sort_instances(ek[0], ek[1]), 10)
    def ranges():
        tile = PC.binning_sorted_tile(sorted_key, plan_tuple=plan.kernel_tuple)
        return OB.extract_tile_ranges(tile, tiles_x * tiles_y)
    (starts, counts), ranges_ms = device_ms(torch, ranges, 20)
    # byte floors: one read and one write of the int64 keys (a radix sort
    # takes several passes), one read of the sorted keys
    other += [dict(name="instance sort (torch.sort of the int64 keys alone)",
                   ms=sort_ms, elements=cap,
                   bound_ms=16 * cap / HBM_BYTES_PER_S * 1e3),
              dict(name="tile ranges (torch.searchsorted)", ms=ranges_ms,
                   tiles=tiles_x * tiles_y,
                   bound_ms=8 * cap / HBM_BYTES_PER_S * 1e3)]
    log(f"[library] sort (keys only) {sort_ms:.4f} ms over {cap} slots, "
        f"ranges {ranges_ms:.4f} ms")

    # kernel 5: blend through the sorted keys into the row table's words
    # (the staged frame must reproduce the renderer's frame)
    bkw = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=w, height=h)
    ent = (sorted_key, rk[4], plan.idx_bits)
    blend_fn = lambda: KB.blend_image_cuda(*ent, starts, counts, **bkw)
    (color, depth), ms = device_ms(torch, blend_fn, 10)
    time_check("blend", blend_fn, ms)
    if not torch.equal(color, hl["out"].color):
        raise RuntimeError("staged frame differs from the renderer's frame")
    (pc, pd, processed), plain_ms = once_ms(
        torch, lambda: KB.blend_tiles_plain(*ent, starts, counts,
                                            tiles_x=tiles_x,
                                            return_processed=True))
    err = blend_subset_err(torch, KB, ent, starts, counts, color, depth,
                           tiles_x=tiles_x, tiles_y=tiles_y, w=w, h=h)
    full_err = float((pc.reshape(tiles_y, tiles_x, 16, 16, 4).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * 16, tiles_x * 16, 4)[:h, :w]
        - color).abs().max())
    log(f"[kernels] blend: full-frame plain vs kernel max |d| {full_err:.3g}")
    if err != 0.0 or full_err != 0.0:
        raise RuntimeError(f"blend: kernel vs plain max |d| {err}, full "
                           f"frame {full_err}")
    n_live = int(counts.sum())
    record("blend", "blend", mono_l["blend"], ms, plain_ms, err, 0.0,
           blend_bytes(torch, KB, ent, starts, processed, 4, w * h),
           BLEND_DECODE_FLOPS * float(processed.sum())
           + BLEND_PAIR_FLOPS * 256.0 * float(processed.sum()))
    stages = dict(project=rows["project"]["ms"], prep=rows["prep"]["ms"],
                  row_expand=rows["row_expand"]["ms"],
                  expand=rows["expand"]["ms"], sort=sort_ms, ranges=ranges_ms,
                  blend=rows["blend"]["ms"])
    log("[stages] " + json.dumps({"stage_ms": stages,
                                  "records_composited": float(processed.sum()),
                                  "live_instances": n_live}))

    # kernels 2 and 4 as the rows-off frame runs them: prep counting full
    # rects, the expand walking them over the gaussian table
    off_l, cap0 = hl["off_launches"], hl["off_capacity"]
    plan0 = OB.make_key_plan(tiles_x * tiles_y, n, near_plane=cam.near_plane,
                             far_plane=cam.far_plane)
    pk0 = KP.project_cuda(*args, **dict(pkw, key_plan=plan0))
    prep0_in = (pk0.rect_word, pk0.rect_h, pk0.words)
    (off0, rect0, mask0), ms = device_ms(
        torch, lambda: KE.binning_prep_cuda(*prep0_in, count_rows=False), 20)
    (off0_p, rect0_p, mask0_p), plain_ms = cuda_ms(
        torch, lambda: KE.binning_prep_plain(*prep0_in, count_rows=False), 3)
    err, flips = check_ints(torch, "prep.rows_off", [
        (off0, off0_p), (rect0, rect0_p), (mask0, mask0_p)])
    record("prep.rows_off", "prep", off_l["prep"], ms, plain_ms, err, flips,
           (6 + 3) * 4 * n + 4,
           PREP_DECODE_FLOPS * n + TILE_TEST_FLOPS * tile_tests(pk0.rect_word,
                                                                pk0.rect_h))
    ekw0 = dict(capacity=cap0, tiles_x=tiles_x, key_plan=plan0)
    exp0_in = (off0, rect0, mask0, pk0.dsw, pk0.words)
    ek0, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*exp0_in, **ekw0), 20)
    ep0, plain_ms = cuda_ms(torch,
                              lambda: KE.expand_slots_plain(*exp0_in, **ekw0), 3)
    err, flips = check_exact("expand.rows_off", list(zip(ek0, ep0)))
    record("expand.rows_off", "expand", off_l["expand"], ms, plain_ms, err,
           flips, expand_bytes(n, cap0, 4 * tested_entries(off0, rect0)),
           (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS) * tested_slots(off0, rect0))
    sorted0 = PC.sort_instances(ek0[0], ek0[1])
    tile0 = PC.binning_sorted_tile(sorted0, plan_tuple=plan0.kernel_tuple)
    color0, _ = KB.blend_image_cuda(
        sorted0, pk0.words, plan0.idx_bits,
        *OB.extract_tile_ranges(tile0, tiles_x * tiles_y), **bkw)
    if not torch.equal(color0, hl["out"].color):
        raise RuntimeError("staged rows-off frame differs from the renderer's")

    # kernel 6: stereo projection, then the stereo modes of 2, 4 and 5
    stereo = st["stereo"]
    views = np.stack([stereo.left.view_matrix, stereo.right.view_matrix])
    projs = np.stack([stereo.left.projection_matrix,
                      stereo.right.projection_matrix])
    centers = np.stack([stereo.left.position, stereo.right.position])
    st_plan = OB.make_key_plan(tiles_x * tiles_y, n, near_plane=cam.near_plane,
                               far_plane=cam.far_plane)
    sargs = (comp, harm, views, projs, centers, np.eye(4, dtype=np.float32))
    skw = dict(pkw, key_plan=st_plan)
    sk, ms = device_ms(torch, lambda: KP.stereo_project_cuda(*sargs, **skw), 20)
    sp, plain_ms = cuda_ms(torch, lambda: KP.stereo_project_plain(*sargs, **skw), 3)
    err, flips = check_ints(torch, "stereo_project", [
        (sk.rect_word, sp.rect_word), (sk.rect_h, sp.rect_h), (sk.dsw, sp.dsw),
        (sk.visible, sp.visible)] + list(zip(sk.words, sp.words)))
    ferr = max(float((getattr(sk, f) - getattr(sp, f)).abs().max())
               for f in ("px_min", "px_max", "py_min", "py_max"))
    if ferr > 1e-3:
        raise RuntimeError(f"stereo_project: pixel bounds max |d| {ferr}")
    record("stereo_project", "stereo_project", st_l["stereo_project"], ms,
           plain_ms, max(err, ferr), flips,
           (11 + n_coeffs) * 4 * n + (10 * 4 + 4 * 4 + 1) * n,
           STEREO_PROJECT_FLOPS * n)

    sprep_in = (sk.rect_word, sk.rect_h, sk.words)
    (soff, srect, smask), ms = device_ms(
        torch, lambda: KE.binning_prep_cuda(*sprep_in, mode="stereo"), 20)
    (soff_p, srect_p, smask_p), plain_ms = cuda_ms(
        torch, lambda: KE.binning_prep_plain(*sprep_in, mode="stereo"), 3)
    err, flips = check_ints(torch, "prep.stereo", [
        (soff, soff_p), (srect, srect_p), (smask, smask_p)])
    record("prep.stereo", "prep", st_l["prep"], ms, plain_ms, err, flips,
           # words 0-2 and 4-6: the stereo cutoff needs no opacity word
           (2 + 6 + 3) * 4 * n + 4,
           2 * PREP_DECODE_FLOPS * n
           + 2 * TILE_TEST_FLOPS * tile_tests(sk.rect_word, sk.rect_h))

    scap = st["capacity"]
    sekw = dict(capacity=scap, tiles_x=tiles_x, key_plan=st_plan, mode="stereo")
    sexp_in = (soff, srect, smask, sk.dsw, sk.words)
    sek, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*sexp_in, **sekw), 20)
    sep, plain_ms = cuda_ms(torch,
                              lambda: KE.expand_slots_plain(*sexp_in, **sekw), 3)
    err, flips = check_exact("expand.stereo", list(zip(sek, sep)))
    record("expand.stereo", "expand", st_l["expand"], ms, plain_ms, err, flips,
           # the test reads words 0-2 and 4-6
           expand_bytes(n, scap, 6 * tested_entries(soff, srect)),
           (2 * EXPAND_DECODE_FLOPS + 2 * TILE_TEST_FLOPS)
           * tested_slots(soff, srect))
    tile_key_order("expand.stereo", sexp_in, sekw, sek, st_plan,
                   tiles_x * tiles_y)

    s_sorted = PC.sort_instances(sek[0], sek[1])
    s_tile = PC.binning_sorted_tile(s_sorted, plan_tuple=st_plan.kernel_tuple)
    s_starts, s_counts = OB.extract_tile_ranges(s_tile, tiles_x * tiles_y)
    sbkw = dict(bkw, n_eyes=2, r2_cutoff=9.0)
    s_ent = (s_sorted, sk.words, st_plan.idx_bits)
    blend_fn = lambda: KB.blend_image_cuda(*s_ent, s_starts, s_counts, **sbkw)
    (scolor, sdepth), ms = device_ms(torch, blend_fn, 10)
    time_check("blend.stereo", blend_fn, ms)
    if not torch.equal(scolor, st["out"].color):
        raise RuntimeError("staged stereo frame differs from the renderer's")
    (_eyes, sprocessed), plain_ms = once_ms(
        torch, lambda: KB.blend_tiles_plain(*s_ent, s_starts, s_counts,
                                            tiles_x=tiles_x, n_eyes=2,
                                            r2_cutoff=9.0,
                                            return_processed=True))
    err = blend_subset_err(torch, KB, s_ent, s_starts, s_counts, scolor,
                           sdepth, tiles_x=tiles_x, tiles_y=tiles_y, w=w, h=h,
                           n_eyes=2, r2_cutoff=9.0)
    if err != 0.0:
        raise RuntimeError(f"blend.stereo: kernel vs plain max |d| {err}")
    s_live = int(s_counts.sum())
    s_flops, s_inside, s_pairs = blend_cutoff_flops(
        torch, KB, s_ent, s_starts, sprocessed, tiles_x=tiles_x, r2_cutoff=9.0)
    record("blend.stereo", "blend", st_l["blend"], ms, plain_ms, err, 0.0,
           # w3 is one shared plane: 7 distinct words an entry
           blend_bytes(torch, KB, s_ent, s_starts, sprocessed, 7, 2 * w * h),
           s_flops)
    log("[stages] " + json.dumps({"stereo_stage_ms": {
        k: rows[k]["ms"] for k in ("stereo_project", "prep.stereo",
                                   "expand.stereo", "blend.stereo")},
        "records_composited": float(sprocessed.sum()),
        "pairs_within_cutoff": s_inside, "pairs": s_pairs,
        "live_instances": s_live}))

    # kernel 7 and the warped modes of 2, 4 and 5 on the foveated frame's
    # tensors: the display-size projection with the physical KeyPlan, then
    # the re-binning, as render_stereo_foveated runs them
    fv_l, target = fv["launches"], fv["target"]
    tables = PD.foveated_device_tables(target, comp.device)
    bounds = tables["bounds"]
    lod = hl["cfg"].foveated_lod
    pw, ph = target.render_width, target.render_height
    ftx, fty = -(-pw // 16), -(-ph // 16)
    f_plan = OB.make_key_plan(ftx * fty, n, near_plane=cam.near_plane,
                              far_plane=cam.far_plane)
    fpk, _ = PD.foveated_packed(
        KP.stereo_project_cuda(*sargs, **dict(pkw, key_plan=f_plan)),
        tables["inv_fit"], tiles_x=ftx, tiles_y=fty)
    fru = fpk.rect_word.to(torch.int64) & 0xFFFFFFFF
    f_min_tx = (fru & 0x3FF).to(torch.int32)
    f_min_ty = ((fru >> 10) & 0x3FF).to(torch.int32)
    gather_fn = lambda: KE.warped_bounds_gather_cuda(bounds, f_min_tx, f_min_ty)
    (gfx, gfy), ms = device_ms(torch, gather_fn, 20)
    time_check("bounds_gather", gather_fn, ms)
    (pfx, pfy), plain_ms = cuda_ms(
        torch, lambda: KE.warped_bounds_gather_plain(bounds, f_min_tx, f_min_ty),
        3)
    for a, b in zip(gfx + gfy, pfx + pfy):
        if not torch.equal(a, b):
            raise RuntimeError("bounds_gather: kernel differs from plain")
    record("bounds_gather", "bounds_gather", fv_l["bounds_gather"], ms,
           plain_ms, 0.0, 0.0, 2 * 128 * 4 + 2 * 4 * n + 14 * 4 * n, 0.0)

    fprep_in = (fpk.rect_word, fpk.rect_h, fpk.words)
    fprep_kw = dict(mode="warped", warped_bounds=bounds, lod_min=lod)
    (foff, frect, fmask), ms = device_ms(
        torch, lambda: KE.binning_prep_cuda(*fprep_in, **fprep_kw), 20)
    (foff_p, frect_p, fmask_p), plain_ms = cuda_ms(
        torch, lambda: KE.binning_prep_plain(*fprep_in, **fprep_kw), 3)
    err, flips = check_ints(torch, "prep.warped", [
        (foff, foff_p), (frect, frect_p), (fmask, fmask_p)])
    # the gather's planes reproduce the kernel's masks through the plain
    # warped masks
    w64 = [x.to(torch.int64) & 0xFFFFFFFF for x in fpk.words]
    gmask, _ = KE.stereo_warped_tile_masks(
        w64[0:3], w64[4:7], (fru >> 20) & 0x3FF, fpk.rect_h.to(torch.int64),
        gfx, gfy, w3=w64[3], lod_min=lod)
    check_ints(torch, "prep.warped mask from bounds_gather", [(gmask, fmask)])
    # the periphery LOD (foveated_lod > 0) on the same tensors
    lod_kw = dict(fprep_kw, lod_min=5.0)
    check_ints(torch, "prep.warped lod_min=5", list(zip(
        KE.binning_prep_cuda(*fprep_in, **lod_kw),
        KE.binning_prep_plain(*fprep_in, **lod_kw))))
    record("prep.warped", "prep", fv_l["prep"], ms, plain_ms, err, flips,
           # words 0-2 and 4-6 (w3 only with the LOD on), the bounds table
           (2 + 6 + (lod > 0) + 3) * 4 * n + 4 + 2 * 128 * 4,
           2 * PREP_DECODE_FLOPS * n
           + 2 * TILE_TEST_FLOPS * tile_tests(fpk.rect_word, fpk.rect_h))

    fcap = fv["capacity"]
    fekw = dict(capacity=fcap, tiles_x=ftx, key_plan=f_plan, mode="warped",
                warped_bounds=bounds)
    fexp_in = (foff, frect, fmask, fpk.dsw, fpk.words)
    fek, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*fexp_in, **fekw), 20)
    fep, plain_ms = cuda_ms(torch,
                              lambda: KE.expand_slots_plain(*fexp_in, **fekw), 3)
    err, flips = check_exact("expand.warped", list(zip(fek, fep)))
    record("expand.warped", "expand", fv_l["expand"], ms, plain_ms, err, flips,
           expand_bytes(n, fcap, 6 * tested_entries(foff, frect, masked_too=True))
           + 2 * 128 * 4,
           (2 * EXPAND_DECODE_FLOPS + 2 * TILE_TEST_FLOPS)
           * tested_slots(foff, frect, masked_too=True))
    tile_key_order("expand.warped", fexp_in, fekw, fek, f_plan, ftx * fty)

    f_sorted = PC.sort_instances(fek[0], fek[1])
    f_tile = PC.binning_sorted_tile(f_sorted, plan_tuple=f_plan.kernel_tuple)
    f_starts, f_counts = OB.extract_tile_ranges(f_tile, ftx * fty)
    coords = (tables["coord_x"], tables["coord_y"])
    fbkw = dict(tiles_x=ftx, tiles_y=fty, width=pw, height=ph, n_eyes=2,
                r2_cutoff=9.0, pixel_coords=coords)
    f_ent = (f_sorted, fpk.words, f_plan.idx_bits)
    blend_fn = lambda: KB.blend_image_cuda(*f_ent, f_starts, f_counts, **fbkw)
    (fcolor, fdepth), ms = device_ms(torch, blend_fn, 10)
    time_check("blend.warped", blend_fn, ms)
    if not torch.equal(fcolor, fv["out"].color):
        raise RuntimeError("staged foveated frame differs from the renderer's")
    (_eyes, fprocessed), plain_ms = once_ms(
        torch, lambda: KB.blend_tiles_plain(*f_ent, f_starts, f_counts,
                                            tiles_x=ftx, n_eyes=2,
                                            r2_cutoff=9.0, pixel_coords=coords,
                                            return_processed=True))
    err = blend_subset_err(torch, KB, f_ent, f_starts, f_counts, fcolor,
                           fdepth, tiles_x=ftx, tiles_y=fty, w=pw, h=ph,
                           n_eyes=2, r2_cutoff=9.0, pixel_coords=coords)
    if err != 0.0:
        raise RuntimeError(f"blend.warped: kernel vs plain max |d| {err}")
    f_live = int(f_counts.sum())
    f_flops, f_inside, f_pairs = blend_cutoff_flops(
        torch, KB, f_ent, f_starts, fprocessed, tiles_x=ftx, r2_cutoff=9.0,
        pixel_coords=coords)
    record("blend.warped", "blend", fv_l["blend"], ms, plain_ms, err, 0.0,
           blend_bytes(torch, KB, f_ent, f_starts, fprocessed, 7, 2 * pw * ph)
           + (ftx + fty) * 256 * 4, f_flops)
    log("[stages] " + json.dumps({"foveated_stage_ms": {
        k: rows[k]["ms"] for k in ("prep.warped", "expand.warped",
                                   "blend.warped")},
        "records_composited": float(fprocessed.sum()),
        "pairs_within_cutoff": f_inside, "pairs": f_pairs,
        "live_instances": f_live, "tiles": [ftx, fty]}))
    # the 16-bit-key modes on the Global (32x16) and Local (16x16) frames'
    # tensors: project depth_key16 at both widths, prep and the expand at
    # tile_w=32 over the d16 KeyPlan, the blend at 32x16 and with first_hit
    # depth; each bit-equal to its plain version
    gl_l, lo_l = d16["global"]["launches"], d16["local"]["launches"]
    d16_stages = {}
    for tw, label, launches in ((32, "global", gl_l), (16, "local", lo_l)):
        dtx, dty = -(-w // tw), -(-h // 16)
        dkw = dict(pkw, tile_w=tw, key_plan=None, depth_key16=True)
        dk, ms = device_ms(torch, lambda: KP.project_cuda(*args, **dkw), 20)
        dp, plain_ms = cuda_ms(torch, lambda: KP.project_plain(*args, **dkw), 3)
        err, flips = check_exact(f"project.d16_{tw}", [
            (dk.rect_word, dp.rect_word), (dk.rect_h, dp.rect_h),
            (dk.dsw, dp.dsw), (dk.visible, dp.visible)]
            + list(zip(dk.words, dp.words)))
        record(f"project.d16_{tw}", "project", launches["project"], ms,
               plain_ms, err, flips,
               (11 + n_coeffs) * 4 * n + (7 * 4 + 1) * n, PROJECT_FLOPS * n)
        d_plan = OB.make_key_plan(dtx * dty, n, depth_span_bits=16)
        dprep_in = (dk.rect_word, dk.rect_h, dk.words)
        if tw == 32:
            (doff, drect, dmask), ms = device_ms(
                torch, lambda: KE.binning_prep_cuda(*dprep_in, tile_w=32), 20)
            dprep_p, plain_ms = cuda_ms(
                torch, lambda: KE.binning_prep_plain(*dprep_in, tile_w=32), 3)
            err, flips = check_exact("prep.tile32", list(zip(
                (doff, drect, dmask), dprep_p)))
            record("prep.tile32", "prep", launches["prep"], ms, plain_ms, err,
                   flips, (6 + 3) * 4 * n + 4,
                   PREP_DECODE_FLOPS * n
                   + TILE_TEST_FLOPS * tile_tests(dk.rect_word, dk.rect_h))
        else:
            doff, drect, dmask = KE.binning_prep_cuda(*dprep_in)
        dcap = d16[label]["stats"]["capacity"]
        dekw = dict(capacity=dcap, tiles_x=dtx, key_plan=d_plan, tile_w=tw)
        dexp_in = (doff, drect, dmask, dk.dsw, dk.words)
        if tw == 32:
            dek, ms = device_ms(
                torch, lambda: KE.expand_slots_cuda(*dexp_in, **dekw), 20)
            dep, plain_ms = cuda_ms(
                torch, lambda: KE.expand_slots_plain(*dexp_in, **dekw), 3)
            err, flips = check_exact("expand.d16_32", list(zip(dek, dep)))
            record("expand.d16_32", "expand", launches["expand"], ms, plain_ms,
                   err, flips,
                   expand_bytes(n, dcap, 4 * tested_entries(doff, drect)),
                   (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS)
                   * tested_slots(doff, drect))
        else:
            dek = KE.expand_slots_cuda(*dexp_in, **dekw)
        d_sorted = PC.sort_instances(dek[0], dek[1])
        d_starts, d_counts = PC.tile_ranges(d_sorted, d_plan, dtx * dty)
        mode = "weighted" if tw == 32 else "first_hit"
        name = "blend.tile32" if tw == 32 else "blend.first_hit"
        if tw == 16:  # Local's per-tile clamp
            d_counts = torch.clamp(d_counts, max=T.config.LOCAL_MAX_PER_TILE)
        d_ent = (d_sorted, dk.words, d_plan.idx_bits)
        dbkw = dict(tiles_x=dtx, tiles_y=dty, width=w, height=h, tile_w=tw,
                    depth_mode=mode)
        blend_fn = lambda: KB.blend_image_cuda(*d_ent, d_starts, d_counts,
                                               **dbkw)
        (dcolor, ddepth), ms = device_ms(torch, blend_fn, 10)
        time_check(name, blend_fn, ms)
        frame = d16[label]["out"]
        if not (torch.equal(dcolor, frame.color)
                and torch.equal(ddepth, frame.depth)):
            raise RuntimeError(f"staged {label} frame differs from the "
                               "renderer's")
        (pc, pd, dprocessed), plain_ms = once_ms(
            torch, lambda: KB.blend_tiles_plain(
                *d_ent, d_starts, d_counts, tiles_x=dtx, tile_w=tw,
                depth_mode=mode, return_processed=True))
        pcol, pdep = KB.assemble_image(pc, pd, tiles_x=dtx, tiles_y=dty,
                                       width=w, height=h, tile_w=tw)
        err = max(float((pcol - dcolor).abs().max()),
                  float((pdep - ddepth).abs().max()))
        if err != 0.0:
            raise RuntimeError(f"{name}: kernel vs plain max |d| {err}")
        record(name, "blend", launches["blend"], ms, plain_ms, err, 0.0,
               blend_bytes(torch, KB, d_ent, d_starts, dprocessed, 4, w * h),
               BLEND_DECODE_FLOPS * float(dprocessed.sum())
               + BLEND_PAIR_FLOPS * float(tw * 16) * float(dprocessed.sum()))
        d16_stages[label] = dict(
            records_composited=float(dprocessed.sum()),
            live_instances=int(d_counts.sum()), tiles=[dtx, dty],
            max_tile_count=int(d_counts.max()))
    log("[stages] " + json.dumps({"d16_stage_ms": {
        k: rows[k]["ms"] for k in ("project.d16_32", "project.d16_16",
                                   "prep.tile32", "expand.d16_32",
                                   "blend.tile32", "blend.first_hit")},
        "d16": d16_stages}))
    # the Hardware frames' modes: prep and the expand in mode "none" on the
    # mono frame's projection (pk0: the same KeyPlan), the one-eye blend
    # with the r^2 <= 9 cutoff and normalized depth, and the dual-eye
    # blend with normalized depth on the stereo frame's tensors; each
    # bit-equal to its plain version and to the renderer's frame
    hw_l, hs_l = hw["launches"], hw["stereo_launches"]
    (hoff, hrect, hmask), ms = device_ms(
        torch, lambda: KE.binning_prep_cuda(*prep0_in, mode="none"), 20)
    (hoff_p, _hrect_p, hmask_p), plain_ms = cuda_ms(
        torch, lambda: KE.binning_prep_plain(*prep0_in, mode="none"), 3)
    if hmask is not None or hmask_p is not None or hrect is not pk0.rect_word:
        raise RuntimeError("prep.none: wrote a mask or a rect word")
    err, flips = check_exact("prep.none", [(hoff, hoff_p)])
    # the rect word and rect_h of each gaussian read, its offset written
    record("prep.none", "prep", hw_l["prep"], ms, plain_ms, err, flips,
           3 * 4 * n + 4, 0.0)
    hcap = hw["capacity"]
    hekw = dict(capacity=hcap, tiles_x=tiles_x, key_plan=plan0, mode="none")
    hexp_in = (hoff, hrect, None, pk0.dsw, pk0.words)
    hek, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*hexp_in, **hekw), 20)
    hep, plain_ms = cuda_ms(torch,
                            lambda: KE.expand_slots_plain(*hexp_in, **hekw), 3)
    err, flips = check_exact("expand.none", list(zip(hek, hep)))
    # the offset, rect word and depth word of each entry, two keys a slot
    record("expand.none", "expand", hw_l["expand"], ms, plain_ms, err, flips,
           (n + 1) * 4 + 2 * 4 * n + 2 * 4 * hcap, 0.0)
    h_sorted, hsort_ms = device_ms(
        torch, lambda: PC.sort_instances(hek[0], hek[1]), 10)
    h_starts, h_counts = PC.tile_ranges(h_sorted, plan0, tiles_x * tiles_y)
    other.append(dict(name="instance sort, Hardware frame (torch.sort of the "
                      "int64 keys alone)", ms=hsort_ms, elements=hcap,
                      bound_ms=16 * hcap / HBM_BYTES_PER_S * 1e3))
    log(f"[library] Hardware sort (keys only) {hsort_ms:.4f} ms over {hcap} "
        f"slots, {int(hek[2])} of them filled")
    hbkw = dict(bkw, r2_cutoff=9.0, depth_mode="normalized")
    h_ent = (h_sorted, pk0.words, plan0.idx_bits)
    blend_fn = lambda: KB.blend_image_cuda(*h_ent, h_starts, h_counts, **hbkw)
    (hcolor, hdepth), ms = device_ms(torch, blend_fn, 10)
    time_check("blend.cutoff_normalized", blend_fn, ms)
    if not (torch.equal(hcolor, hw["out"].color)
            and torch.equal(hdepth, hw["out"].depth)):
        raise RuntimeError("staged Hardware frame differs from the renderer's")
    (pc, pd, hprocessed), plain_ms = once_ms(
        torch, lambda: KB.blend_tiles_plain(
            *h_ent, h_starts, h_counts, tiles_x=tiles_x, r2_cutoff=9.0,
            depth_mode="normalized", return_processed=True))
    pcol, pdep = KB.assemble_image(pc, pd, tiles_x=tiles_x, tiles_y=tiles_y,
                                   width=w, height=h)
    err = max(float((pcol - hcolor).abs().max()),
              float((pdep - hdepth).abs().max()))
    if err != 0.0:
        raise RuntimeError(f"blend.cutoff_normalized: kernel vs plain max |d| "
                           f"{err}")
    h_flops, h_inside, h_pairs = blend_cutoff_flops(
        torch, KB, h_ent, h_starts, hprocessed, tiles_x=tiles_x, r2_cutoff=9.0,
        n_eyes=1)
    record("blend.cutoff_normalized", "blend", hw_l["blend"], ms, plain_ms,
           err, 0.0, blend_bytes(torch, KB, h_ent, h_starts, hprocessed, 4,
                                 w * h), h_flops)
    nbkw = dict(sbkw, depth_mode="normalized")
    blend_fn = lambda: KB.blend_image_cuda(*s_ent, s_starts, s_counts, **nbkw)
    (ncolor, ndepth), ms = device_ms(torch, blend_fn, 10)
    time_check("blend.stereo_normalized", blend_fn, ms)
    if not (torch.equal(ncolor, hw["stereo_out"].color)
            and torch.equal(ndepth, hw["stereo_out"].depth)):
        raise RuntimeError("staged Hardware stereo frame differs from the "
                           "renderer's")
    (eyes, nprocessed), plain_ms = once_ms(
        torch, lambda: KB.blend_tiles_plain(
            *s_ent, s_starts, s_counts, tiles_x=tiles_x, n_eyes=2,
            r2_cutoff=9.0, depth_mode="normalized", return_processed=True))
    full = [KB.assemble_image(tc, td, tiles_x=tiles_x, tiles_y=tiles_y,
                              width=w, height=h) for tc, td in eyes]
    err = max(float((torch.cat([c for c, _ in full], 1) - ncolor).abs().max()),
              float((torch.cat([d for _, d in full], 1) - ndepth).abs().max()))
    if err != 0.0:
        raise RuntimeError(f"blend.stereo_normalized: kernel vs plain max |d| "
                           f"{err}")
    record("blend.stereo_normalized", "blend", hs_l["blend"], ms, plain_ms,
           err, 0.0, blend_bytes(torch, KB, s_ent, s_starts, nprocessed, 7,
                                 2 * w * h), s_flops)
    log("[stages] " + json.dumps({"hardware_stage_ms": {
        k: rows[k]["ms"] for k in ("project", "prep.none", "expand.none",
                                   "blend.cutoff_normalized",
                                   "blend.stereo_normalized")},
        "sort": hsort_ms, "records_composited": float(hprocessed.sum()),
        "pairs_within_cutoff": h_inside, "pairs": h_pairs,
        "slot_total": int(hek[2]), "live_instances": int(h_counts.sum())}))

    log("[timing check] " + json.dumps(timing_check))
    order = ("project", "prep", "prep.rows_off", "row_expand", "expand",
             "expand.rows_off", "blend", "stereo_project", "prep.stereo",
             "expand.stereo", "blend.stereo", "bounds_gather", "prep.warped",
             "expand.warped", "blend.warped", "project.d16_32",
             "project.d16_16", "prep.tile32", "expand.d16_32", "blend.tile32",
             "blend.first_hit", "prep.none", "expand.none",
             "blend.cutoff_normalized", "blend.stereo_normalized")
    return [rows[k] for k in order], other


def built_expand_tables(torch, M, KE, device, seed: int = 5):
    """Entry tables that put the expand's CTA-level search at its edges
    (1024 slots a CTA), each (label, offsets, rect, mask, dsw, 8 word rows,
    capacity), made from ``seed`` on the host and moved to ``device``:
    entries owning 6,000 slots (more than 4 CTAs), a run of 1-slot and
    culled entries, a row table's dead tail (offsets repeating the total), a
    total equal to the capacity and one above it.  Ordinary entries mix
    unmasked rects (exact test per slot), MASKED windows and culled entries;
    the records are random ellipses over a 1920x1080 grid."""
    g = torch.Generator().manual_seed(seed)

    def uni(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int64)

    def f16(x):
        return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF

    def words(n):
        rows = []
        for shift in (0.0, -25.0):  # the right eye's record sits 25 px left
            mx, my = uni(0, 1920, n) + shift, uni(0, 1080, n)
            rows += [f16(mx) | (f16(my) << 16),
                     ints(0, 65536, n) | (f16(uni(0.5, 40.0, n)) << 16),
                     f16(uni(0.5, 40.0, n)) | (f16(uni(0.5, 30.0, n)) << 16),
                     ints(0, 1 << 32, n)]
        rows[7] = rows[3]  # the eyes share the colour/opacity word
        return rows

    def entries(kinds):
        n = len(kinds)
        kinds = torch.tensor(kinds, dtype=torch.int64)
        min_tx, min_ty = ints(0, 110, n), ints(0, 62, n)
        rect_w, rect_h = ints(1, 11, n), ints(1, 7, n)
        win_w, win_h = ints(1, 9, n), ints(1, 5, n)
        window = torch.zeros(n, dtype=torch.int64)
        for dy in range(4):
            for dx in range(8):
                window |= ((dx < win_w) & (dy < win_h)).to(torch.int64) << (dy * 8 + dx)
        mask = ints(0, 1 << 32, n) & window
        mask = torch.where(mask == 0, 1, mask)
        one = kinds == 4                    # 1-slot unmasked entry
        rect_w = torch.where(one, 1, torch.where(kinds == 1, win_w, rect_w))
        rect_h = torch.where(one, 1, rect_h)
        mask = torch.where(kinds == 5, torch.ones_like(mask) << ints(0, 32, n),
                           mask)              # 1-slot MASKED entry
        big = kinds == 3                    # 100 x 60 tiles: 6,000 slots
        min_tx, min_ty = torch.where(big, 5, min_tx), torch.where(big, 2, min_ty)
        rect_w, rect_h = torch.where(big, 100, rect_w), torch.where(big, 60, rect_h)
        masked = (kinds == 1) | (kinds == 5)
        count = torch.where(masked, KE._popcount(mask), rect_w * rect_h)
        count = torch.where(kinds == 2, 1, count)   # culled: one dead slot
        count = torch.where(kinds == 6, 0, count)   # a row table's dead tail
        rect = (min_tx | (min_ty << 10) | (rect_w << 20)
                | torch.where(masked, KE.MASKED_BIT, 0)
                | torch.where(kinds == 2, KE.CULLED_BIT, 0))
        rect = torch.where(kinds == 6, 0, rect)
        mask = torch.where(masked, mask, 0)
        offsets = torch.zeros(n + 1, dtype=torch.int64)
        offsets[1:] = torch.cumsum(count, 0)
        return offsets, rect, mask, ints(0, 1 << 31, n), words(n)

    def ordinary(n):  # 60% unmasked rects, 30% MASKED windows, 10% culled
        return [0 if k < 6 else 1 if k < 9 else 2
                for k in ints(0, 10, n).tolist()]

    specs = [
        ("entries over 4 CTAs", ordinary(300) + [3] + ordinary(300) + [3]
         + ordinary(300), None),
        ("1-slot and culled run", ordinary(50) + [2, 4, 2, 5] * 1500
         + ordinary(50), None),
        ("row dead tail", ordinary(2000) + [6] * 1500, None),
        ("total == capacity", ordinary(300) + [3] + ordinary(700), 0),
        ("total > capacity", ordinary(2500) + [6] * 300, -1000),
    ]
    out = []
    for label, kinds, cap_delta in specs:
        off, rect, mask, dsw, w = entries(kinds)
        total = int(off[-1])
        cap = total + cap_delta if cap_delta is not None \
            else -(-total // 1024) * 1024 + 1024 + 37
        out.append((label, off.to(torch.int32).to(device),
                    M.to_i32(rect).to(device), M.to_i32(mask).to(device),
                    dsw.to(torch.int32).to(device),
                    [M.to_i32(x).to(device) for x in w], cap))
    return out


#: sizes of the built prep inputs: one gaussian, part of a warp, a block
#: and its edges, the edge of a look-back window of 32 tiles (4097 = 16
#: tiles + 1) and the headline's 1M + 1
BUILT_PREP_SIZES = (1, 31, 255, 256, 257, 4097, 1_000_001)
BUILT_PREP_SCENES = ("culled", "oversized", "skewed", "mixed")


def built_prep_inputs(torch, M, n: int, scene: str, seed: int = 9):
    """(rect_word, rect_h, 8 word rows) int32 CPU tensors of ``n`` built
    gaussians, made from ``seed``, that put prep's per-warp test balancing
    and its look-back scan at their edges.  Scenes: "culled" (every
    gaussian CULLED, its window still tested); "oversized" (rects of 9-30 x
    5-12 tiles: 32 tests each, counted as rows or full rects); "skewed" (in
    each warp one lane, a different one per warp, holds an 8x4 window of 32
    tests and the rest a 1x1 rect of 1 test); "mixed" (rects of 0-12 x 0-6
    tiles, 10% culled).  Records: ellipses of sigma 0.5-40 px centred within
    a tile of their window on a 120 x 68 tile grid (the right eye 25 px to
    the left), random orientation, colour and opacity; the eyes share w3."""
    g = torch.Generator().manual_seed(seed)

    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int64)

    def f16(x):
        return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF

    min_tx, min_ty = ints(0, 112), ints(0, 64)
    culled = torch.zeros(n, dtype=torch.bool)
    if scene == "culled":
        rect_w, rect_h = ints(0, 13), ints(0, 7)
        culled[:] = True
    elif scene == "oversized":
        rect_w, rect_h = ints(9, 31), ints(5, 13)
    elif scene == "skewed":
        idx = torch.arange(n)
        heavy = (idx % 32) == (idx // 32) % 32
        rect_w = torch.where(heavy, 8, 1)
        rect_h = torch.where(heavy, 4, 1)
    else:
        rect_w, rect_h = ints(0, 13), ints(0, 7)
        culled = uni(0.0, 1.0) < 0.1
    rect_word = (min_tx | (min_ty << 10) | (rect_w << 20)
                 | torch.where(culled, 1 << 30, 0))
    # means within one tile of the window, so that tests pass and fail
    span_x = torch.clamp(rect_w, max=8).to(torch.float32) + 2.0
    span_y = torch.clamp(rect_h, max=4).to(torch.float32) + 2.0
    mx = (min_tx.to(torch.float32) - 1.0 + span_x * uni(0.0, 1.0)) * 16.0
    my = (min_ty.to(torch.float32) - 1.0 + span_y * uni(0.0, 1.0)) * 16.0
    rows = []
    for shift in (0.0, -25.0):
        rows += [f16(mx + shift) | (f16(my) << 16),
                 ints(0, 65536) | (f16(uni(0.5, 40.0)) << 16),
                 f16(uni(0.5, 40.0)) | (f16(uni(0.5, 30.0)) << 16),
                 ints(0, 1 << 32)]
    rows[7] = rows[3]
    return (M.to_i32(rect_word), rect_h.to(torch.int32),
            [M.to_i32(r) for r in rows])


def phase_expand_tables(torch, bounds):
    """The expand on built tables against its plain version, in modes mono,
    stereo, warped and none (the tables' MASKED bits cleared and no mask:
    a full-rect table): all outputs bit-equal, the overflow flag as the
    capacity says."""
    from gsm_renderer_tpu_torch import mathlib as M
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.ops import binning as OB

    for label, off, rect, mask, dsw, words, cap in built_expand_tables(
            torch, M, KE, bounds.device):
        n = rect.shape[0]
        total = int(off[n])
        plan = OB.make_key_plan(120 * 68, n, near_plane=0.1, far_plane=50.0)
        counts = (off[1:] - off[:-1]).to(torch.int64)
        live = {}
        for mode in ("mono", "stereo", "warped", "none"):
            kw = dict(capacity=cap, tiles_x=120, key_plan=plan, mode=mode,
                      warped_bounds=bounds if mode == "warped" else None)
            w = words[:KE.MODE_WORDS[mode]]
            r, m = rect, mask
            if mode == "none":
                r, m = rect & 0x7FFFFFFF, None
            got = KE.expand_slots_cuda(off, r, m, dsw, w, **kw)
            want = KE.expand_slots_plain(off, r, m, dsw, w, **kw)
            bad, elems, worst = mismatches(torch, list(zip(got, want)))
            if bad:
                raise RuntimeError(f"expand tables, {label}, {mode}: {bad} of "
                                   f"{elems} outputs differ (max |d| {worst})")
            if int(got[3]) != int(total > cap):
                raise RuntimeError(f"expand tables, {label}: overflow flag "
                                   f"{int(got[3])} with total {total}, "
                                   f"capacity {cap}")
            live[mode] = int((got[0] != -1).sum())
        log(f"[expand tables] {label}: {n} entries, total {total}, capacity "
            f"{cap}, largest entry {int(counts.max())} slots, "
            f"{int((counts == 1).sum())} 1-slot, {int((counts == 0).sum())} "
            f"0-slot; live slots {json.dumps(live)}; bit-equal to plain")


#: prep modes of the built-input phase: (label, record words, options)
PREP_MODES = (("mono count_rows", 4, dict(count_rows=True)),
              ("mono full rects", 4, dict()),
              ("stereo", 8, dict(mode="stereo")),
              ("warped lod_min 0", 8, dict(mode="warped", lod_min=0.0)),
              ("warped lod_min 5", 8, dict(mode="warped", lod_min=5.0)),
              ("none", 4, dict(mode="none")))


def phase_prep_tables(torch, bounds) -> dict:
    """Prep and the row expand on built inputs (``built_prep_inputs``, every
    size and scene): prep in each of PREP_MODES, the row expand over the
    count_rows table with the row capacity below the row total (half of
    it), equal to it and above it (+ 300).  Each kernel runs three times
    back to back and the three outputs must be equal (stale look-back
    state would show); the first is held against the plain version with
    ``check_ints``.  Prints each mode's flip share and a digest of its
    outputs over all cases (equal digests on two trees: equal outputs).
    Returns {mode: dict(flips, elements, digest)}."""
    import hashlib

    from gsm_renderer_tpu_torch import mathlib as M
    from gsm_renderer_tpu_torch.kernels import expand as KE

    dev = bounds.device
    res = {}

    def flat(out):
        # mode none returns no mask
        return [t for x in out if x is not None
                for t in (x if isinstance(x, list) else [x])]

    def hold(mode, label, kernel, args, kw, want):
        outs = [flat(kernel(*args, **kw)) for _ in range(3)]
        for other in outs[1:]:
            if not all(torch.equal(a, b) for a, b in zip(outs[0], other)):
                raise RuntimeError(f"{label}: back-to-back calls differ")
        pairs = list(zip(outs[0], flat(want)))
        bad, total, _worst = mismatches(torch, pairs)
        check_ints(torch, label, pairs)
        r = res.setdefault(mode, dict(flips=0, elements=0,
                                      digest=hashlib.sha256()))
        r["flips"] += bad
        r["elements"] += total
        for t in outs[0]:
            r["digest"].update(t.cpu().numpy().tobytes())
        return outs[0]

    for n in BUILT_PREP_SIZES:
        for scene in BUILT_PREP_SCENES:
            rw, rh, w8 = built_prep_inputs(torch, M, n, scene)
            rw, rh, w8 = rw.to(dev), rh.to(dev), [w.to(dev) for w in w8]
            gen = torch.Generator().manual_seed(n)
            dsw = torch.randint(0, 1 << 31, (n,), dtype=torch.int32,
                                generator=gen).to(dev)
            for mode, k, kw in PREP_MODES:
                if kw.get("mode") == "warped":
                    kw = dict(kw, warped_bounds=bounds)
                args = (rw, rh, w8[:k])
                out = hold(mode, f"prep tables {mode} n={n} {scene}",
                           KE.binning_prep_cuda, args, kw,
                           KE.binning_prep_plain(*args, **kw))
                if not kw.get("count_rows"):
                    continue
                off, rect, mask = out
                total = int(off[n])
                for cap in (max(total // 2, 1), total, total + 300):
                    rargs, rkw = (off, rect, mask, dsw, w8[:4]), dict(
                        row_capacity=cap)
                    got = hold("row expand", f"row tables cap={cap} n={n} "
                               f"{scene} (total {total})", KE.row_expand_cuda,
                               rargs, rkw, KE.row_expand_plain(*rargs, **rkw))
                    # got: offsets2, rect2, mask2, dsw2, w0..w3, row_overflow
                    if int(got[-1]) != int(total > cap):
                        raise RuntimeError(f"row tables n={n} {scene}: row "
                                           f"overflow {int(got[-1])}, total "
                                           f"{total}, capacity {cap}")
        log(f"[prep tables] n={n}: {len(BUILT_PREP_SCENES)} scenes x "
            f"{len(PREP_MODES)} modes and 3 row capacities: calls equal, "
            "within check_ints of plain")
    out = {m: dict(flips=r["flips"], elements=r["elements"],
                   flip_share=r["flips"] / r["elements"],
                   digest=r["digest"].hexdigest()[:16])
           for m, r in res.items()}
    log("[prep tables] " + json.dumps(out))
    return out


def phase_small(torch, T):
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

    n, w, h = 20_000, 512, 384
    ds = generate_visible_gaussians(n, sh_degree=3, seed=11,
                                    scale_range=(0.005, 0.05))
    cam = T.make_camera(w, h, far=50.0)
    gi_g, gi_c = ds.to_input(), ds.to_input(device="cpu")
    stereo = T.make_side_by_side_stereo(cam, ipd=0.1)
    target = T.make_rate_maps(w, h, min_rate=FOV_MIN_RATE, radius=FOV_RADIUS)
    bits16 = dict(depth_sort_key_precision=T.DepthSortKeyPrecision.BITS16)
    for label, cls, opt, frame in (
            ("rows off", T.DepthFirstRenderer, dict(row_expand=False), "mono"),
            ("rows on", T.DepthFirstRenderer, {}, "mono"),
            ("stereo", T.DepthFirstRenderer, {}, "stereo"),
            ("foveated", T.DepthFirstRenderer, {}, "foveated"),
            ("global", T.GlobalRenderer, {}, "mono"),
            ("local", T.LocalRenderer, {}, "mono"),
            ("depth16", T.DepthFirstRenderer, bits16, "mono"),
            ("hardware", T.HardwareRenderer, {}, "mono"),
            ("hardware depth16", T.HardwareRenderer, bits16, "mono"),
            ("hardware stereo", T.HardwareRenderer, {}, "stereo"),
            ("hardware foveated", T.HardwareRenderer, {}, "foveated")):
        cfg = T.RendererConfig(sh_degree=3, precision=T.Precision.FLOAT32,
                               max_width=w, max_height=h, **opt)
        rg, rc = cls(cfg), cls(cfg, device="cpu")
        if frame == "foveated":
            og = rg.render_stereo_foveated(gi_g, stereo, target)
            oc = rc.render_stereo_foveated(gi_c, stereo, target)
        elif frame == "stereo":
            og = rg.render_stereo(gi_g, stereo, w, h)
            oc = rc.render_stereo(gi_c, stereo, w, h)
        else:
            og, oc = rg.render(gi_g, cam, w, h), rc.render(gi_c, cam, w, h)
        small_compare(label, og, oc)
    # the frame functions at other tiles and options
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD
    from gsm_renderer_tpu_torch.pipelines.global_ import global_frame

    kw = dict(sh_degree=3, alpha_threshold=0.005, total_ink_threshold=2.0,
              near_plane=cam.near_plane, far_plane=cam.far_plane,
              input_is_srgb=False, capacity=64 * 4096)
    view = (cam.view_matrix, cam.projection_matrix, cam.position)
    rig = PD._stereo_rig(stereo)
    for label, fn in (
            ("tiles 8x8 rows", lambda gi: PD.depth_first_frame(
                gi, *view, width=w, height=h, tile_w=8, tile_h=8,
                row_capacity=1 << 16, **kw)),
            ("tiles 32x32 rows", lambda gi: PD.depth_first_frame(
                gi, *view, width=w, height=h, tile_w=32, tile_h=32,
                row_capacity=1 << 16, **kw)),
            ("max_per_tile 64", lambda gi: PD.depth_first_frame(
                gi, *view, width=w, height=h, max_per_tile=64, **kw)),
            ("global no exact test", lambda gi: global_frame(
                gi, *view, width=w, height=h, exact_tile_test=False, **kw)),
            ("stereo 8x8", lambda gi: PD.depth_first_stereo_frame(
                gi, *rig, width=w, height=h, tile_w=8, tile_h=8, **kw)),
            ("foveated 8x8", lambda gi: PD.depth_first_stereo_foveated_frame(
                gi, *rig, PD.foveated_device_tables(
                    target, gi.positions.device, 8, 8), display_width=w,
                display_height=h, render_width=target.render_width,
                render_height=target.render_height, tile_w=8, tile_h=8,
                **kw)),
            # tile sides that are not powers of two (phase 4o's kernels)
            ("tiles 7x5 rows", lambda gi: PD.depth_first_frame(
                gi, *view, width=w, height=h, tile_w=7, tile_h=5,
                row_capacity=1 << 17, **kw)),
            ("tiles 24x24 rows", lambda gi: PD.depth_first_frame(
                gi, *view, width=w, height=h, tile_w=24, tile_h=24,
                row_capacity=1 << 16, **kw)),
            ("global 48x16", lambda gi: global_frame(
                gi, *view, width=w, height=h, tile_w=48, tile_h=16, **kw)),
            ("stereo 24x24", lambda gi: PD.depth_first_stereo_frame(
                gi, *rig, width=w, height=h, tile_w=24, tile_h=24, **kw))):
        small_compare(label, fn(gi_g), fn(gi_c))
    small_large_tiles(T)


def small_large_tiles(T):
    """Phase 6's frames at tile sides over 64 pixels (phase 4L's kernels),
    on a smaller scene, where a 256x256 tile holds the whole frame: the mono
    frame function at 65x16, 97x33, 256x256, 4096x1 and 1x4096 on the card
    and on the CPU."""
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD

    n, w, h = 4_000, 192, 128
    ds = generate_visible_gaussians(n, sh_degree=3, seed=12,
                                    scale_range=(0.005, 0.05))
    cam = T.make_camera(w, h, far=50.0)
    gi_g, gi_c = ds.to_input(), ds.to_input(device="cpu")
    view = (cam.view_matrix, cam.projection_matrix, cam.position)
    kw = dict(sh_degree=3, alpha_threshold=0.005, total_ink_threshold=2.0,
              near_plane=cam.near_plane, far_plane=cam.far_plane,
              input_is_srgb=False, capacity=64 * 4096, width=w, height=h)
    for tile in ((65, 16), (97, 33), (256, 256), (4096, 1), (1, 4096)):
        fn = lambda gi, tile=tile: PD.depth_first_frame(
            gi, *view, tile_w=tile[0], tile_h=tile[1], **kw)
        small_compare(f"tiles {tile[0]}x{tile[1]}", fn(gi_g), fn(gi_c))
    largest_tile(T, gi_g, view, kw)
    overflow_records_check()


def largest_tile(T, gi, view, kw):
    """The largest tile, 4096x4096 (2^24 pixels: 16,384 CTAs of the blend's
    large-tile path), on the card: the frame function's image bit-equal to
    the plain blend, on the card, of the frame's own sorted chain (the CPU
    would take minutes over 2^24 pixels a record)."""
    import torch
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD

    tk = dict(tile_w=4096, tile_h=4096)
    out = PD.depth_first_frame(gi, *view, **tk, **kw)
    plan = OB.make_key_plan(1, gi.count, near_plane=kw["near_plane"],
                            far_plane=kw["far_plane"])
    srt, _packed, words, _total, _overflow = PC.mono_packed_sorted(
        gi, *view, None, key_plan=plan, row_capacity=0, tiles_x=1,
        tiles_y=1, mode="mono", **tk, **kw)
    color, depth = KB.assemble_image(
        *KB.blend_tiles_plain(srt.key, words, srt.idx_bits, srt.starts,
                              srt.counts, tiles_x=1, **tk),
        tiles_x=1, tiles_y=1, width=kw["width"], height=kw["height"], **tk)
    if not (torch.equal(out.color, color) and torch.equal(out.depth, depth)):
        raise RuntimeError("tile 4096x4096: the frame differs from the plain "
                           "blend of its chain")
    log(f"[small] tile 4096x4096: bit-equal to the plain blend on the card "
        f"({int(srt.counts[0])} records)")


#: overflow_records_check's blends: (label, tile, eyes, r2_cutoff, depth
#: mode, pixel coordinates); the split layout culls records in all but the
#: 8x4-block "blocks"
OVERFLOW_CASES = (("mono", (48, 48), 1, 0.0, "weighted", False),
                  ("large", (65, 65), 1, 0.0, "first_hit", False),
                  ("stereo", (24, 24), 2, 9.0, "weighted", False),
                  ("hardware", (24, 24), 1, 9.0, "normalized", False),
                  ("blocks", (16, 16), 1, 0.0, "weighted", False),
                  ("stereo coords", (24, 24), 2, 9.0, "weighted", True),
                  ("mono coords", (48, 48), 1, 0.0, "weighted", True),
                  ("large coords", (80, 72), 1, 0.0, "weighted", True))


def overflow_records_check(device: str = "cuda"):
    """Records whose f16 fields overflowed (exponent 31: +-inf and NaN bits
    in the means and the scales, at theta 0 and not) and coordinate tables
    holding +-inf and NaN, through the split layout's culling blends (one
    CTA, cluster, large tile) and an 8x4-block instance: each image
    bit-equal to the plain version's on the card, NaN where it is NaN."""
    import torch
    from gsm_renderer_tpu_torch.kernels import blend as KB

    g = torch.Generator().manual_seed(13)
    odd = (0x7C00, 0xFC00, 0x7E00, 0xFE00)  # +inf, -inf, NaN, -NaN bits
    for label, (tw, th), eyes, r2, mode, coords in OVERFLOW_CASES:
        tiles_x, tiles_y, per = 3, 2, 600
        n = tiles_x * tiles_y * per
        tile = torch.arange(n) // per
        span = torch.tensor([tw, th], dtype=torch.float32)
        mean = (torch.stack([tile % tiles_x, tile // tiles_x], 1) * span
                + (torch.rand(n, 2, generator=g) * 1.4 - 0.2) * span)
        f16 = lambda x: x.to(torch.float16).view(torch.int16).to(
            torch.int64) & 0xFFFF  # noqa: E731
        w0 = f16(mean[:, 0]) | f16(mean[:, 1]) << 16
        theta = torch.randint(1, 1 << 16, (n,), generator=g)
        s1 = f16(0.5 + torch.rand(n, generator=g) * 6)
        s2 = f16(0.5 + torch.rand(n, generator=g) * 6)
        for t in range(tiles_x * tiles_y):
            for k, bits in enumerate(odd):
                i = t * per + 40 * k + t
                w0[i] = (w0[i] & 0xFFFF0000) | bits if k % 2 == 0 \
                    else (w0[i] & 0xFFFF) | bits << 16
                w0[i + 1] = (w0[i + 1] & 0xFFFF) | bits << 16
                theta[i] = theta[i + 1] = 0 if t % 2 == 0 else theta[i]
                s1[i + 2] = bits
                s2[i + 3] = bits
        w = torch.stack([
            w0, theta | s1 << 16,
            s2 | f16(1 + torch.rand(n, generator=g) * 30) << 16,
            torch.randint(0, 1 << 24, (n,), generator=g)
            | torch.randint(60, 256, (n,), generator=g) << 24])
        words = torch.cat([w.to(torch.int32)] * eyes).to(device)
        key = torch.arange(n, dtype=torch.int64, device=device)
        starts = torch.arange(0, n, per, dtype=torch.int32, device=device)
        counts = torch.full_like(starts, per)
        kw = dict(tiles_x=tiles_x, tile_w=tw, tile_h=th, n_eyes=eyes,
                  r2_cutoff=r2, depth_mode=mode)
        if coords:
            p = torch.arange(tw * th)
            cx = ((p % tw)[None] + (torch.arange(tiles_x) * tw)[:, None]).float()
            cy = ((p // tw)[None] + (torch.arange(tiles_y) * th)[:, None]).float()
            for k, v in enumerate((float("inf"), float("-inf"), float("nan"))):
                cx[k % tiles_x, 37 * k + 5] = v
                cy[k % tiles_y, 41 * k + 9] = v
            kw["pixel_coords"] = (cx.to(device), cy.to(device))
        frame = dict(tiles_y=tiles_y, width=tiles_x * tw, height=tiles_y * th)
        color, depth = KB.blend_image_cuda(key, words, 32, starts, counts,
                                           **kw, **frame)
        eyes_out = KB.blend_tiles_plain(key, words, 32, starts, counts, **kw)
        full = [KB.assemble_image(c, d, tiles_x=tiles_x, tile_w=tw,
                                  tile_h=th, **frame)
                for c, d in (eyes_out if eyes == 2 else [eyes_out])]
        pc = torch.cat([c for c, _ in full], 1)
        pd = torch.cat([d for _, d in full], 1)

        def same(a, b):
            return (torch.equal(a.isnan(), b.isnan())
                    and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
        nan = int(pc.isnan().any(-1).sum())
        if not (same(color, pc) and same(depth, pd)):
            raise RuntimeError(f"overflowed records, {label} {tw}x{th}: the "
                               "kernel differs from the plain version")
        log(f"[small] overflowed records, {label} {tw}x{th}: bit-equal to "
            f"the plain version ({nan} NaN pixels)")


def small_compare(label, og, oc):
    """Phase 6's check of a CUDA frame against the CPU frame: colour
    within 1e-3; the rest logged."""
    cerr = float((og.color.cpu() - oc.color).abs().max())
    derr = float((og.depth.cpu() - oc.depth).abs().max())
    log(f"[small] {label}: cuda vs cpu colour max |d| {cerr:.3g}, depth "
        f"max |d| {derr:.3g}, visible {int(og.header.visible_count)} vs "
        f"{int(oc.header.visible_count)}, instances "
        f"{int(og.header.total_instances)} vs "
        f"{int(oc.header.total_instances)}, slots "
        f"{int(og.header.slot_total)} vs {int(oc.header.slot_total)}")
    if cerr > 1e-3:
        raise RuntimeError(f"small frame {label}: cuda vs cpu colour max "
                           f"|d| {cerr}")


#: ``--blends`` and phase 1's occupancy lines: (frame, tile) of every
#: general-layout and large-tile blend of the kernel table (phases 4o, 4L,
#: 4m) on the headline scene; a frame function's own blend ("mono", rows
#: off; "stereo", two eyes with the r2 9 cutoff; "hardware", one eye with
#: it and normalized depth; "local", first_hit; "global", the 16-bit-key
#: chain; "foveated", pixel coordinates), "stereo_no_cutoff", the stereo
#: frame's tensors blended without the cutoff, or "band", band 1 of 4 with
#: its tile row offset (phase 4m's blend row)
BLEND_AB = (("mono", (24, 24)), ("mono", (12, 12)), ("mono", (20, 12)),
            ("mono", (48, 16)), ("mono", (48, 48)), ("mono", (64, 64)),
            ("mono", (7, 5)), ("stereo", (24, 24)),
            ("stereo_no_cutoff", (24, 24)), ("foveated", (24, 24)),
            ("hardware", (24, 24)), ("local", (24, 24)),
            ("global", (48, 16)), ("band", (24, 24)), ("mono", (65, 65)),
            ("mono", (96, 80)), ("mono", (128, 64)), ("mono", (128, 128)),
            ("stereo", (96, 96)), ("stereo_no_cutoff", (96, 96)),
            ("foveated", (128, 128)), ("hardware", (128, 128)),
            ("local", (96, 96)), ("global", (128, 64)), ("band", (128, 128)))
BLEND_AB_MODES = {"mono": (1, "weighted", 0.0), "global": (1, "weighted", 0.0),
                  "band": (1, "weighted", 0.0),
                  "stereo": (2, "weighted", 9.0),
                  "stereo_no_cutoff": (2, "weighted", 0.0),
                  "foveated": (2, "weighted", 9.0),
                  "hardware": (1, "normalized", 9.0),
                  "local": (1, "first_hit", 0.0)}


def blend_occupancy(frame: str, tile) -> list:
    """The launches of the blend of ``frame`` (a BLEND_AB_MODES key) at
    ``tile``: for each, its threads a CTA, CTAs a tile, CTAs an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at that CTA size),
    the warps an SM they hold, and the kernel's registers
    (``cudaFuncGetAttributes``), from ``gsm_blend_occupancy``."""
    import ctypes

    from gsm_renderer_tpu_torch import _native
    from gsm_renderer_tpu_torch.kernels import blend as KB

    fn = _native.load("blend").gsm_blend_occupancy
    eyes, depth_mode, r2 = BLEND_AB_MODES[frame]
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    n = fn(eyes, KB.DEPTH_MODES[depth_mode], r2, tile[0], tile[1], out)
    if n < 0:
        raise RuntimeError(f"gsm_blend_occupancy failed at {frame} {tile}")
    return [dict(threads=out[4 * k], ctas_a_tile=out[4 * k + 1],
                 ctas_an_sm=out[4 * k + 2],
                 warps_an_sm=out[4 * k + 2] * out[4 * k] // 32,
                 registers=out[4 * k + 3]) for k in range(n)]


def expf_zero_check(torch) -> int:
    """The floats from the blend's kExpZero down to -inf whose expf is not
    exactly 0 on the card (``gsm_expf_zero_check``, compiled as the
    blends' expf): the blend's record culling without a cutoff needs none
    (it fails otherwise)."""
    import ctypes

    from gsm_renderer_tpu_torch import _native

    fn = _native.load("blend").gsm_expf_zero_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    err = fn(count.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gsm_expf_zero_check: CUDA error {err}")
    nonzero = int(count)
    log(f"[build] expf below the blend's zero exponent: {nonzero} floats "
        "not exactly 0")
    if nonzero:
        raise RuntimeError("expf is not exactly 0 below the blend's zero "
                           f"exponent at {nonzero} floats")
    return nonzero


def blend_ab_frame(T, frame: str, tile, scene: dict):
    """``run(capacity)`` of the frame function whose blend ``--blends``
    times (see BLEND_AB)."""
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD
    from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
    from gsm_renderer_tpu_torch.pipelines.hardware import hardware_frame
    from gsm_renderer_tpu_torch.pipelines.local import local_frame

    gi, prepared, view, rig = (scene[k] for k in ("gi", "prepared", "view",
                                                  "rig"))
    kw = frame_statics(scene, tile)
    if frame in ("mono", "hardware", "local", "global"):
        fn = {"mono": PD.depth_first_frame, "hardware": hardware_frame,
              "local": local_frame, "global": global_frame}[frame]
        return lambda cap: fn(gi, *view, prepared, capacity=cap, width=W,
                              height=H, **kw)
    if frame == "foveated":
        target = scene["target"]
        tables = PD.foveated_device_tables(target, gi.positions.device, *tile)
        return lambda cap: PD.depth_first_stereo_foveated_frame(
            gi, *rig, tables, prepared, capacity=cap, display_width=W,
            display_height=H, render_width=target.render_width,
            render_height=target.render_height,
            foveated_lod=scene["cfg"].foveated_lod, **kw)
    return lambda cap: PD.depth_first_stereo_frame(
        gi, *rig, prepared, capacity=cap, width=W, height=H, **kw)


def band_blend_call(scene: dict, tile, n: int):
    """(args, keywords) of the blend of band 1 of 4 of the headline scene at
    ``tile`` (phase 4m's blend row: its tile row offset), its chain built
    on this card as band_kernel_rows builds it."""
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.parallel import multichip as MC
    from gsm_renderer_tpu_torch.pipelines import common as PC

    cam, cfg = scene["cam"], scene["cfg"]
    tw, th = tile
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    bs, bands = MC.resolve_band_starts(tiles_y, 4)
    block = MC.project_block(
        scene["gi"], *scene["view"], width=W, height=H, tile_w=tw,
        tile_h=th, sh_degree=3, near_plane=cam.near_plane,
        far_plane=cam.far_plane, alpha_threshold=cfg.alpha_threshold,
        total_ink_threshold=cfg.total_ink_threshold, input_is_srgb=False)
    plan = OB.make_key_plan(tiles_x * bands, n, near_plane=cam.near_plane,
                            far_plane=cam.far_plane)
    off, rect, mask, dsw = KE.binning_prep_band(
        *block[4:8], band0=bs[1], band1=bs[2], key_plan=plan)
    words = list(block[:4])
    keys = KE.expand_slots(off, rect, mask, dsw, words,
                           capacity=-(-int(off[n]) // 4096) * 4096,
                           tiles_x=tiles_x, key_plan=plan,
                           tile_row_offset=bs[1], tile_w=tw, tile_h=th)
    srt = PC.sort_and_ranges(keys[:2], plan, tiles_x * bands)
    return ((srt.key, words, srt.idx_bits, srt.starts, srt.counts),
            dict(tiles_x=tiles_x, tiles_y=bands, width=W, height=bands * th,
                 tile_w=tw, tile_h=th, tile_row_offset=bs[1]))


def blends_only(torch, T, native, n: int = 1_000_000) -> int:
    """``--blends``: every general-layout and large-tile blend mode
    (BLEND_AB) on the headline scene, for A/Bs of the blend's other tiles
    between trees (parent, change, change, parent in one run).  Each
    frame function runs once at a probed capacity with its blend call
    captured; that call is then timed alone (CUDA events behind a sleep
    kernel), its kernels' device times split by a torch.profiler trace, its
    outputs hashed (equal digests across trees: bit-equal images) and its
    launches' occupancy printed.  One JSON line."""
    import hashlib

    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels.project import cached_projection_inputs
    from gsm_renderer_tpu_torch.pipelines import depth_first as PD

    out = native.build_all()
    report = ptxas_report((out / "blend.log").read_text())
    registers = {k: v for k, v in report.items()
                 if not k.startswith("blend_kernel")}
    log("[blends] ptxas: " + json.dumps(registers))
    cuobjdump = Path(native._nvcc()).parent / "cuobjdump"
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(out / "libblend.so")],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        log("[blends] inner loop SASS: " + json.dumps(
            {k: v for k, v in sass_loop_counts(sass).items()
             if not k.startswith("blend_kernel")}))
    for label, r in report.items():
        if r.get("spill_bytes", 0) > 0:
            raise RuntimeError(f"{label} spills registers: {r}")
    expf_zero_check(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    ds = generate_visible_gaussians(n, sh_degree=3, seed=7,
                                    scale_range=(0.002, 0.012))
    gi = ds.to_input(T.Precision.FLOAT32)
    cam = T.make_camera(W, H, far=50.0)
    scene = dict(gi=gi, cam=cam, prepared=cached_projection_inputs(gi, 3),
                 cfg=T.RendererConfig(sh_degree=3, max_width=W, max_height=H,
                                      precision=T.Precision.FLOAT32),
                 view=(cam.view_matrix, cam.projection_matrix, cam.position),
                 rig=PD._stereo_rig(T.make_side_by_side_stereo(cam)),
                 target=T.make_rate_maps(W, H, min_rate=FOV_MIN_RATE,
                                         radius=FOV_RADIUS))
    real, calls = KB.blend_image_cuda, []

    def capture(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    res = {}
    for frame, tile in BLEND_AB:
        if frame == "band":
            args, kw = band_blend_call(scene, tile, n)
        else:
            run = blend_ab_frame(T, frame.replace("_no_cutoff", ""), tile,
                                 scene)
            cap = probed_capacity(run, n)
            KB.blend_image_cuda = capture
            try:
                run(cap)
            finally:
                KB.blend_image_cuda = real
            args, kw = calls.pop()
        if frame == "stereo_no_cutoff":
            kw = dict(kw, r2_cutoff=0.0)
        call = lambda: real(*args, **kw)  # noqa: E731
        img, ms = device_ms(torch, call, 10 if tile[0] * tile[1] <= 4096 else 4)
        digest = hashlib.sha1()
        for t in img:
            if t is not None:
                digest.update(t.cpu().numpy().tobytes())
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        split = {name: dict(ms=ms_ / count, launches=count)
                 for name, (ms_, count) in device_kernel_stats(prof).items()
                 if "blend_kernel" in name}
        label = f"{frame}.{tile[0]}x{tile[1]}"
        res[label] = dict(ms=ms, digest=digest.hexdigest()[:16],
                          split=split, occupancy=blend_occupancy(frame, tile),
                          records=int(args[4].sum()))
        log(f"[blends] {label}: " + json.dumps(res[label]))
    print(json.dumps({"blends": res, "registers": registers,
                      "card": smi.stdout.strip()}))
    return 0


def frames_only(torch, T, native, n: int = 1_000_000) -> int:
    """``--frames``: the mono frame loops alone -- the headline and the
    realistic scene, rows on and off -- each with its CUDA-event frame
    times, its host/device split and a traced idle share; one JSON line.
    Copied into another checkout, it times that checkout's package, so two
    trees compare in one session (parent, change, change, parent)."""
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

    native.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    ds = generate_visible_gaussians(n, sh_degree=3, seed=7,
                                    scale_range=(0.002, 0.012))
    scenes = dict(headline=(ds.to_input(T.Precision.FLOAT32),
                            T.make_camera(W, H, far=50.0)),
                  realistic=realistic_scene(T, n))
    res = {}
    for scene, (gi, cam) in scenes.items():
        for rows in (True, False):
            r = T.DepthFirstRenderer(T.RendererConfig(
                sh_degree=3, precision=T.Precision.FLOAT32, max_width=W,
                max_height=H, row_expand=rows))
            render = lambda r=r, gi=gi, cam=cam: r.render(gi, cam, W, H)
            label = f"{scene} rows_{'on' if rows else 'off'}"
            out, st = timed_frames(torch, render)
            check_frame(torch, out, label)
            tr = trace_frames(torch, render, f"{label} trace", frames=5)
            res[label] = dict(
                avg=st["avg"], min=st["min"], max=st["max"],
                wall_avg=st["wall_avg"], split=frame_split(torch, render),
                trace=None if tr is None else {
                    k: tr[k] for k in ("frame_wall_ms", "device_busy_ms",
                                       "idle_share", "uneven_launches")})
    print(json.dumps({"frames": res, "card": smi.stdout.strip()}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import gsm_renderer_tpu_torch as T
        from gsm_renderer_tpu_torch import _native
        from gsm_renderer_tpu_torch.kernels import blend, expand, project
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--frames"]:
        return frames_only(torch, T, _native)
    if sys.argv[1:] == ["--blends"]:
        return blends_only(torch, T, _native)
    kernels_only = sys.argv[1:] == ["--kernels"]
    if kernels_only:
        # another tree's kernels may still launch the separate scan kernels
        global REQUIRE_ONE_PASS_SCAN
        REQUIRE_ONE_PASS_SCAN = False
    kernels = [project.PROJECT, expand.PREP, expand.ROW_EXPAND, expand.EXPAND,
               blend.BLEND, project.STEREO_PROJECT, expand.BOUNDS_GATHER,
               expand.PREP_BAND]
    t0 = time.perf_counter()
    smi = phase_build(_native)
    hl = phase_headline(torch, T, kernels)
    real = None
    if not kernels_only:
        require_one_pass_scan(trace_frames(
            torch, lambda: hl["r"].render(hl["gi"], hl["cam"], W, H),
            "trace"), "headline")
        real = phase_realistic(torch, T)
        phase_scene_files(torch, T, kernels, hl)
        phase_profile(torch, hl)
    st = phase_stereo(torch, T, kernels, hl)
    fv = phase_foveated(torch, T, kernels, hl, st)
    d16 = phase_d16(torch, T, kernels, hl, real)
    hw = phase_hardware(torch, T, kernels, hl, st, fv)
    band_rows, band_other, tile_rows = [], [], []
    if not kernels_only:
        t1 = time.perf_counter()
        tile_rows, tiles8 = phase_tiles(torch, T, kernels, hl, st, fv, real)
        log(f"[tiles] phase 4t took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        odd_rows, odd = phase_odd_tiles(torch, T, kernels, hl, st, fv)
        tile_rows += odd_rows
        log(f"[odd tiles] phase 4o took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        large_rows, large = phase_large_tiles(torch, T, kernels, hl, st, fv)
        tile_rows += large_rows
        log(f"[large tiles] phase 4L took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        band_rows, band_other = phase_multichip(torch, T, kernels, hl, tiles8,
                                                odd, large)
        phase_fallback(torch, T, kernels, hl)
        log(f"[multichip, fallback] phases 4m and 4s took "
            f"{time.perf_counter() - t1:.1f} s")
    rows, other = phase_kernels(torch, T, hl, st, fv, d16, hw)
    if kernels_only:  # the 8x8 rows too (phase 4t's), for A/Bs of the tiles
        tile_rows = mono_tile_frame(torch, T, kernels, hl, (8, 8))[1]
    rows, other = rows + band_rows + tile_rows, other + band_other
    from gsm_renderer_tpu_torch.pipelines.depth_first import foveated_device_tables
    bounds = foveated_device_tables(fv["target"],
                                    hl["gi"].positions.device)["bounds"]
    if not kernels_only:
        phase_expand_tables(torch, bounds)
    tables = phase_prep_tables(torch, bounds)
    if kernels_only:
        print(json.dumps({"kernels": rows, "prep_tables": tables,
                          "card": smi}))
        return 0
    phase_small(torch, T)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"library_ops": other}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
