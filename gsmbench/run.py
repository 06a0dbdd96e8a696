"""Run one cell of the renderer's benchmark once and print one JSON line.

    python3 gsmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``gsmbench/`` and
the renderer (``gsm_renderer_tpu_torch``), on a machine with the CUDA
devices the cell asks for; without them it exits non-zero and prints no
result.  The renderer builds its kernels into its own ``_build/``
directory inside the checkout on first use; later runs reuse them.

A run makes the cell's scene on the device from ``--seed``, builds the
renderer and its entry point, warms up (the first frame at the full
capacity, then the capacity lock-in) and then:

- ``--trace 0``: renders frames one at a time (one in flight: the call,
  then ``torch.cuda.synchronize()``), each at the next pose of the
  traffic's loop, for ``--seconds`` seconds, and reports the cell's
  end-to-end metrics;
- ``--trace 1``: renders the workload's ``trace_frames`` frames under the
  profiler, then measures the host/device split of a frame, and reports
  the per-layer metrics (each read by ``gsmbench/metrics/<name>.py``) with
  the trace's ``busy_s``, ``window_s`` and ``breakdown``.

Either way it keeps a seeded sample of the frames it rendered and a
seeded sample, as large, of those that overflowed (dropped splats: each
frame's ``header.overflow`` is copied to pinned host memory before the
frame's own synchronize, so no read waits on the device), frees the
renderer, renders the same poses with the plain reference
(``gsmbench/reference``) and compares (``harness/check.py``); the numbers
and their limits are the last lines of standard error and the last key of
the result.  ``failed`` counts the frames that overflowed or raised.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gsm_renderer_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit():
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 and got.stdout.strip() else None


def renderer_config(T, cfg):
    """The renderer's RendererConfig of a configuration: its
    ``renderer_config`` fields, an enum field by its value, and the input
    ``precision``."""
    import dataclasses

    fields = dict(cfg["renderer_config"], precision=cfg["precision"])
    default = T.RendererConfig()
    for f in dataclasses.fields(default):
        cur = getattr(default, f.name)
        if f.name in fields and hasattr(cur, "value") and not hasattr(
                fields[f.name], "value"):
            fields[f.name] = type(cur)(fields[f.name])
    return T.RendererConfig(**fields)


class Sample:
    """A seeded reservoir of ``k`` frames: each rendered frame stays with
    probability k / (frames so far).  ``stream`` tells two reservoirs of
    one seed apart."""

    def __init__(self, k: int, seed: int, stream: int = 7):
        import numpy as np

        self.k = k
        self.rng = np.random.default_rng([int(seed), stream])
        self.kept, self.seen = [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j] = item


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell``; returns the result without printing it.  The
    caller has checked the device."""
    import torch

    import gsm_renderer_tpu_torch as T
    from gsmbench.harness import check, scene as scene_mod, timing, traffic
    from gsmbench.harness import trace as trace_mod
    from gsmbench.reference.render import Reference

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, wl = cell.config, cell.workload
    entry = cell.entry()

    t_scene = time.perf_counter()
    scene = scene_mod.make_scene(cfg["scene"], seed, device,
                                 torch.float16 if cfg["precision"] == "float16"
                                 else torch.float32)
    sync()
    t_warm = time.perf_counter()
    gi = T.GaussianInput(**scene)
    renderer = getattr(T, cfg["renderer"])(renderer_config(T, cfg),
                                           device=device)
    frame = entry.build(T, cfg, renderer, gi)
    loop = traffic.poses(cell.traffic, cfg["viewpoint"], seed)
    n_loop = len(loop)
    next_pose = [0]

    def pose():
        i = next_pose[0]
        next_pose[0] += 1
        return i % n_loop

    for _ in range(wl["warmup_frames"]):
        frame(loop[pose()])
        sync()
    sample = Sample(wl["sample_frames"], seed)
    overflowed = Sample(wl["sample_frames"], seed, stream=8)
    flag = torch.zeros((), dtype=torch.int32, pin_memory=cuda)
    failures = []
    # a traced frame marks the copy, so that the trace leaves it out
    harness_op = (lambda: torch.profiler.record_function(trace_mod.HARNESS_OP)) \
        if trace else contextlib.nullcontext

    def one(k=None):
        i = pose()
        try:
            out = frame(loop[i])
            with harness_op():
                flag.copy_(out.header.overflow, non_blocking=True)
            sync()
        except Exception:  # a frame that raised counts as failed; the run goes on
            failures.append(traceback.format_exc())
            return
        kept = (i, out.color, out.depth, out.header.visible_count)
        (overflowed if int(flag) else sample).offer(kept)

    result = dict(correct=False, attempted=0, failed=0, metrics={})
    setup_s = time.perf_counter() - T_START
    print(f"setup: {t_scene - T_START:.3f} s to the scene, scene "
          f"{t_warm - t_scene:.3f} s, renderer and warm-up "
          f"{time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    if not trace:
        times = []
        w0 = time.perf_counter()
        end = w0
        while end - w0 < seconds:
            t0 = time.perf_counter()
            one()
            end = time.perf_counter()
            times.append(end - t0)
        window_s = end - w0
        frame_ms = [t * 1e3 for t in times]
        print("frame ms: min %.4f median %.4f p95 %.4f max %.4f over %d"
              % (min(frame_ms), timing.percentile(frame_ms, 50.0),
                 timing.percentile(frame_ms, 95.0), max(frame_ms),
                 len(frame_ms)), file=sys.stderr)
        e2e = dict(frame_ms=(window_s * 1e3 / len(times), "ms"),
                   frame_p95_ms=(timing.percentile(frame_ms, 95.0), "ms"),
                   setup_s=(setup_s, "s"))
    else:
        cycles = timing.sleep_cycles_per_ms()
        tr = trace_mod.trace_frames(one, wl["trace_frames"])
        per_frame = tr["launches"] / tr["frames"]
        n_split = max(1, min(5, int(600 // max(per_frame, 1.0))))
        for _ in range(3):
            split = timing.frame_split(lambda k: frame(loop[pose()]), n_split,
                                       cycles)
            if split["host_ahead"]:
                break
        sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result["attempted"] = sample.seen + overflowed.seen + len(failures)
    result["failed"] = overflowed.seen + len(failures)
    for f in failures[:1]:
        print(f, file=sys.stderr)

    # the renderer's state goes before the reference runs
    kept = sample.kept + overflowed.kept
    del frame, renderer, one, sample, overflowed
    for key in [k for k in gi.__dict__ if k.startswith("_")]:
        del gi.__dict__[key]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = Reference(scene, sh_degree=cfg["scene"]["sh_degree"],
                    alpha_threshold=cfg["renderer_config"].get("alpha_threshold", 0.005),
                    tile=cfg["tile"])
    readings, counts = [], None
    t_ref = time.perf_counter()
    for i, color, depth, visible in kept:
        rf = entry.reference(ref, cfg, loop[i])
        readings.append(check.compare(color, depth, int(visible), rf))
        counts = counts or rf.counts
        del rf
    print(f"reference: {len(kept)} frames ({result['failed'] - len(failures)} "
          f"overflowed in the run) in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    numbers = check.worst(readings) if readings else {
        k: float("inf") for k in check.NAMES}
    limits = wl["limits"]
    result["correct"] = bool(readings) and check.judge(numbers, limits) \
        and result["attempted"] > 0

    dev = dict(platform="gpu" if cuda else device.type,
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=cell.chips, memory_peak_bytes=int(peak))
    if cuda:
        dev["power_limit"] = _power_limit()
    if not trace:
        e2e["peak_mem_gib"] = (peak / 2 ** 30, "GiB")
        wanted = [m["name"] for m in cell.end_to_end]
        result["metrics"] = {k: dict(value=e2e[k][0], unit=e2e[k][1])
                             for k in wanted if k in e2e}
    else:
        ctx = dict(trace=tr, split=split, counts=counts, config=cfg)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        result["metrics"] = metrics
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = trace_mod.breakdown(tr)
        unmatched = sorted({trace_mod.short(k) for k in tr["kernels"]
                            if trace_mod.layer_of(k) == "glue"})
        print("glue kernels: " + json.dumps(unmatched), file=sys.stderr)
    result["device"] = dev
    result["checks"] = {k: dict(value=numbers[k], limit=limits[k])
                        for k in check.NAMES}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gsmbench.harness import cell as cell_mod

    cell = cell_mod.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"modules that no run may load are loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
