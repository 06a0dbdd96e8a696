#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gsm_renderer_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. Build the CUDA kernels from ``gsm_renderer_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print the card's name and power limit.
2. The headline frame through the user entry point
   ``DepthFirstRenderer(config).render``: 1M gaussians, SH3, float32,
   1920x1080, row_expand=False.  Two capacity lock-in frames, 3 warm-up and
   10 timed frames (CUDA events); every kernel's launch count is set to 0
   just before these frames and read just after.  Requires overflow 0, a
   finite image and some non-black pixels.
3. Each kernel on the frame's own intermediate tensors against its plain
   PyTorch version on the card: integer outputs equal (counted mismatches
   capped at 1e-4 of the elements), the blend within 1e-4 on the 64 heaviest
   and 64 random tiles.  Times kernel, plain version, the instance sort and
   the tile ranges; computes each kernel's bound from this run's inputs.
4. A small frame (20k gaussians, 512x384) on the card vs the same renderer
   on the CPU (plain versions): colour within 1e-3.
   Between phases 2 and 3 a torch.profiler trace of 10 headline frames
   prints the device busy time and the kernel time by name.
5. The last line is {"ok": true, "device": {...}}.

Without a CUDA device, or outside the repository, it prints no result and
exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet (dense, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# float32 operations per element, counted from the kernels' source
# (transcendentals, sqrt and division counted as one each)
PROJECT_FLOPS = 520        # per gaussian at SH3
PREP_DECODE_FLOPS = 30     # per gaussian: conic decode and cutoff
TILE_TEST_FLOPS = 65       # per minQuadRect <= cutoff test
EXPAND_DECODE_FLOPS = 30   # per tested slot, plus one tile test
BLEND_DECODE_FLOPS = 30    # per record decoded
BLEND_PAIR_FLOPS = 25      # per (pixel, record) composited

KERNEL_SOURCES = {
    "project": ("gsm_renderer_tpu_torch/csrc/project.cu",
                "gsm_renderer_tpu/kernels/project.py:99"),
    "prep": ("gsm_renderer_tpu_torch/csrc/binning.cu",
             "gsm_renderer_tpu/kernels/expand.py:735"),
    "expand": ("gsm_renderer_tpu_torch/csrc/binning.cu",
               "gsm_renderer_tpu/kernels/expand.py:550"),
    "blend": ("gsm_renderer_tpu_torch/csrc/blend.cu",
              "gsm_renderer_tpu/kernels/blend.py:335"),
}


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


def device_kernel_ms(prof, reps: int) -> dict:
    """Device time per call of every CUDA kernel a profiler saw, by name."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = out.get(e.key, 0.0) + us / 1e3 / reps
    return out


def device_ms(torch, fn, reps: int):
    """(last result, device ms per call): the summed device time of the
    kernels ``fn`` launches, from a torch.profiler trace of ``reps`` calls
    after one warm-up -- host gaps between the calls are excluded.  Falls
    back to CUDA events around the calls if the profiler records no device
    time, and says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
    ms = sum(device_kernel_ms(prof, reps).values())
    if ms > 0.0:
        return res, ms
    log("[timer] the profiler saw no device time: timing with CUDA events")
    return cuda_ms(torch, fn, reps)


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(native):
    t0 = time.perf_counter()
    out = native.build_all()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s into {out}")
    for name in native.SOURCES:
        for line in (out / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_headline(torch, T, kernels, n: int = 1_000_000):
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

    w, h = 1920, 1080
    ds = generate_visible_gaussians(n, sh_degree=3, seed=7,
                                    scale_range=(0.002, 0.012))
    cam = T.make_camera(w, h, far=50.0)
    cfg = T.RendererConfig(sh_degree=3, precision=T.Precision.FLOAT32,
                           max_width=w, max_height=h, row_expand=False)
    gi = ds.to_input(T.Precision.FLOAT32)
    r = T.DepthFirstRenderer(cfg)

    for k in kernels:
        k.launches = 0
    out = None
    for _ in range(2 + 3):  # capacity lock-in, then warm-up
        out = r.render(gi, cam, w, h)
    torch.cuda.synchronize()
    times = []
    t0 = time.perf_counter()
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render(gi, cam, w, h)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 10
    launches = {k.name: k.launches for k in kernels}

    ms = [s.elapsed_time(e) for s, e in times]
    hd = out.header
    capacity = r._cap_state[(r._mono_key, n)]["cap"]
    stats = dict(avg=sum(ms) / len(ms), min=min(ms), max=max(ms),
                 wall_avg=wall_ms, msplats_per_s=n / (sum(ms) / len(ms)) / 1e3,
                 visible=int(hd.visible_count),
                 total_instances=int(hd.total_instances),
                 slot_total=int(hd.slot_total), capacity=capacity,
                 overflow=int(hd.overflow))
    log("[headline] " + json.dumps({"headline_frame_ms": stats}))
    color = out.color
    if stats["overflow"] != 0:
        raise RuntimeError("headline frame overflowed")
    if not torch.isfinite(color).all() or not torch.isfinite(out.depth).all():
        raise RuntimeError("headline frame is not finite")
    nonblack = float((color[..., :3].amax(-1) > 0.02).float().mean())
    log(f"[headline] non-black fraction {nonblack:.4f}")
    if nonblack <= 0.0:
        raise RuntimeError("headline frame is black")
    for k in kernels:
        if launches[k.name] <= 0:
            raise RuntimeError(f"kernel {k.name} was not launched by the frame")
    return dict(r=r, gi=gi, cam=cam, cfg=cfg, out=out, n=n, w=w, h=h,
                capacity=capacity, launches=launches, stats=stats)


def phase_trace(torch, hl):
    """Device busy share and kernel time by name over 10 headline frames,
    from a torch.profiler trace (profiler on: the host is slower than in the
    timed frames, so this idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    r, gi, cam, w, h = hl["r"], hl["gi"], hl["cam"], hl["w"], hl["h"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            r.render(gi, cam, w, h)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ms, name[:60]) for name, ms in
                   device_kernel_ms(prof, 10).items()), reverse=True)
    busy = sum(ms for ms, _ in rows)
    if busy == 0.0:
        log("[trace] the profiler recorded no device time: idle share not measured")
        return
    log("[trace] " + json.dumps({
        "frame_wall_ms": wall_ms / 10, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / (wall_ms / 10),
        "kernels": [dict(ms=ms, name=name) for ms, name in rows[:14]]}))


def phase_kernels(torch, T, hl):
    from gsm_renderer_tpu_torch.kernels import blend as KB
    from gsm_renderer_tpu_torch.kernels import expand as KE
    from gsm_renderer_tpu_torch.kernels import project as KP
    from gsm_renderer_tpu_torch.ops import binning as OB
    from gsm_renderer_tpu_torch.pipelines import common as PC

    n, w, h, cam, cfg = hl["n"], hl["w"], hl["h"], hl["cam"], hl["cfg"]
    tiles_x, tiles_y = -(-w // 16), -(-h // 16)
    comp, harm = KP.cached_projection_inputs(hl["gi"], 3)
    plan = OB.make_key_plan(tiles_x * tiles_y, n, near_plane=cam.near_plane,
                            far_plane=cam.far_plane)
    pkw = dict(width=w, height=h, tile_w=16, tile_h=16, sh_degree=3,
               near_plane=cam.near_plane, far_plane=cam.far_plane,
               alpha_threshold=cfg.alpha_threshold,
               total_ink_threshold=cfg.total_ink_threshold,
               input_is_srgb=False, key_plan=plan)
    args = (comp, harm, cam.view_matrix, cam.projection_matrix, cam.position)
    rows, other = {}, []

    def record(name, ms, plain_ms, err, flips, nbytes, flops):
        b, by = bound(nbytes, flops)
        src, replaces = KERNEL_SOURCES[name]
        rows[name] = dict(name=name, route="cuda", source=src,
                          replaces=replaces, launches=hl["launches"][name],
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by, library_ms=None,
                          flips=flips)
        log(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b:.4f} ms by {by}), max_abs_err {err}, flips {flips}")

    def check_ints(name, pairs):
        bad, total, worst = mismatches(torch, pairs)
        if bad > 1e-4 * total:
            raise RuntimeError(f"{name}: {bad} of {total} outputs differ")
        return worst, bad / total

    # kernel 1: project
    pk, ms = device_ms(torch, lambda: KP.project_cuda(*args, **pkw), 20)
    pp, plain_ms = device_ms(torch, lambda: KP.project_plain(*args, **pkw), 3)
    err, flips = check_ints("project", [
        (pk.rect_word, pp.rect_word), (pk.rect_h, pp.rect_h), (pk.dsw, pp.dsw),
        (pk.visible, pp.visible)] + list(zip(pk.words, pp.words)))
    n_coeffs = harm.shape[0]
    record("project", ms, plain_ms, err, flips,
           (11 + n_coeffs) * 4 * n + (7 * 4 + 1) * n, PROJECT_FLOPS * n)

    # kernel 2: prep
    prep_in = (pk.rect_word, pk.rect_h, pk.words)
    (off, rect, mask), ms = device_ms(
        torch, lambda: KE.binning_prep_cuda(*prep_in), 20)
    (off_p, rect_p, mask_p), plain_ms = device_ms(
        torch, lambda: KE.binning_prep_plain(*prep_in), 3)
    err, flips = check_ints("prep", [(off, off_p), (rect, rect_p), (mask, mask_p)])
    rw = pk.rect_word.to(torch.int64) & 0xFFFFFFFF
    tests = (torch.clamp((rw >> 20) & 0x3FF, max=8)
             * torch.clamp(pk.rect_h.to(torch.int64), max=4))
    record("prep", ms, plain_ms, err, flips, (6 + 3) * 4 * n + 4,
           PREP_DECODE_FLOPS * n + TILE_TEST_FLOPS * float(tests.sum()))

    # kernel 3: expand
    cap = hl["capacity"]
    ekw = dict(capacity=cap, tiles_x=tiles_x, key_plan=plan)
    exp_in = (off, rect, mask, pk.dsw, pk.words)
    ek, ms = device_ms(torch, lambda: KE.expand_slots_cuda(*exp_in, **ekw), 20)
    ep, plain_ms = device_ms(torch, lambda: KE.expand_slots_plain(*exp_in, **ekw), 3)
    # key1, key2, the (4, C) words, the slot total and the overflow flag
    err, flips = check_ints("expand", list(zip(ek, ep)))
    counts_g = (off[1:] - off[:-1]).to(torch.int64)
    ru = rect.to(torch.int64) & 0xFFFFFFFF
    tested = float(counts_g[((ru >> 30) & 3) == 0].sum())  # visible, unmasked
    record("expand", ms, plain_ms, err, flips,
           (n + 1) * 4 + 7 * 4 * n + 6 * 4 * cap,
           (EXPAND_DECODE_FLOPS + TILE_TEST_FLOPS) * tested)

    # instance sort and tile ranges (library calls)
    (sorted_key, table), sort_ms = device_ms(
        torch, lambda: PC.sort_instances(ek[0], ek[1], ek[2]), 10)
    def ranges():
        tile = PC.binning_sorted_tile(sorted_key, plan_tuple=plan.kernel_tuple)
        return OB.extract_tile_ranges(tile, tiles_x * tiles_y)
    (starts, counts), ranges_ms = device_ms(torch, ranges, 20)
    other += [dict(name="instance sort (torch.sort on int64 + gather)",
                   ms=sort_ms, elements=cap),
              dict(name="tile ranges (torch.searchsorted)", ms=ranges_ms,
                   tiles=tiles_x * tiles_y)]
    log(f"[library] sort {sort_ms:.4f} ms over {cap} slots, ranges "
        f"{ranges_ms:.4f} ms")

    # kernel 4: blend (the staged frame must reproduce the renderer's frame)
    bkw = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=w, height=h)
    (color, depth), ms = device_ms(
        torch, lambda: KB.blend_image_cuda(table, starts, counts, **bkw), 10)
    if not torch.equal(color, hl["out"].color):
        raise RuntimeError("staged frame differs from the renderer's frame")
    (pc, pd, processed), plain_ms = device_ms(
        torch, lambda: KB.blend_tiles_plain(table, starts, counts,
                                            tiles_x=tiles_x,
                                            return_processed=True), 1)
    gen = torch.Generator().manual_seed(0)
    heavy = torch.argsort(counts.cpu(), descending=True)[:64]
    rand = torch.randperm(tiles_x * tiles_y, generator=gen)[:64]
    sub = torch.unique(torch.cat([heavy, rand])).to(counts.device)
    sc, sd = KB.blend_tiles_plain(table, starts, counts, tiles_x=tiles_x,
                                  tiles=sub)
    pix = torch.arange(256, device=sub.device)
    ys = (sub // tiles_x)[:, None] * 16 + pix[None, :] // 16
    xs = (sub % tiles_x)[:, None] * 16 + pix[None, :] % 16
    inside = ys < h
    kc = color[ys.clamp(max=h - 1), xs]
    kd = depth[ys.clamp(max=h - 1), xs]
    err = max(float((kc - sc).abs()[inside].max()),
              float((kd - sd).abs()[inside].max()))
    if err > 1e-4:
        raise RuntimeError(f"blend: kernel vs plain max |d| {err}")
    full_err = float((pc.reshape(tiles_y, tiles_x, 16, 16, 4).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * 16, tiles_x * 16, 4)[:h, :w]
        - color).abs().max())
    log(f"[kernels] blend: full-frame plain vs kernel max |d| {full_err:.3g}")
    n_live = int(counts.sum())
    pairs = 256.0 * float(processed.sum())
    record("blend", ms, plain_ms, err, 0.0,
           16 * n_live + 8 * tiles_x * tiles_y + (16 + 4) * w * h,
           BLEND_DECODE_FLOPS * float(processed.sum())
           + BLEND_PAIR_FLOPS * pairs)
    stages = dict(project=rows["project"]["ms"], prep=rows["prep"]["ms"],
                  expand=rows["expand"]["ms"], sort=sort_ms, ranges=ranges_ms,
                  blend=rows["blend"]["ms"])
    log("[stages] " + json.dumps({"stage_ms": stages,
                                  "records_composited": float(processed.sum()),
                                  "live_instances": n_live}))
    return [rows[k] for k in ("project", "prep", "expand", "blend")], other


def phase_small(torch, T):
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

    n, w, h = 20_000, 512, 384
    ds = generate_visible_gaussians(n, sh_degree=3, seed=11,
                                    scale_range=(0.005, 0.05))
    cam = T.make_camera(w, h, far=50.0)
    cfg = T.RendererConfig(sh_degree=3, precision=T.Precision.FLOAT32,
                           max_width=w, max_height=h, row_expand=False)
    og = T.DepthFirstRenderer(cfg).render(ds.to_input(), cam, w, h)
    oc = T.DepthFirstRenderer(cfg, device="cpu").render(
        ds.to_input(device="cpu"), cam, w, h)
    cerr = float((og.color.cpu() - oc.color).abs().max())
    derr = float((og.depth.cpu() - oc.depth).abs().max())
    log(f"[small] cuda vs cpu: colour max |d| {cerr:.3g}, depth max |d| "
        f"{derr:.3g}, visible {int(og.header.visible_count)} vs "
        f"{int(oc.header.visible_count)}, instances "
        f"{int(og.header.total_instances)} vs {int(oc.header.total_instances)}")
    if cerr > 1e-3:
        raise RuntimeError(f"small frame: cuda vs cpu colour max |d| {cerr}")


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
    kernels = [project.PROJECT, expand.PREP, expand.EXPAND, blend.BLEND]
    t0 = time.perf_counter()
    smi = phase_build(_native)
    hl = phase_headline(torch, T, kernels)
    phase_trace(torch, hl)
    rows, other = phase_kernels(torch, T, hl)
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
