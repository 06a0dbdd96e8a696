"""A torch.profiler trace of some frames, reduced to device time by kernel,
by layer, the device's busy time and the idle gaps by what the host did.

Caveats, from the renderer's earlier traces on the H100: the profiler has
lost a kernel record of repeated calls there (busy may read low by one
kernel), and it slows the host, so the idle share it reads is an upper
bound of the untraced frames'.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

#: (layer, substrings of its device kernels' names), first match wins;
#: ``row_expand_kernel`` before ``expand_kernel``.  A device operation no
#: name claims belongs to the sort where a host op of ``SORT_OPS`` launched
#: it (the sort's index fill, its scratch memsets and copies); what is left
#: is "glue": PyTorch's own kernels (elementwise, reductions, fills,
#: copies) of the pipelines.
LAYER_KERNELS = (
    ("project", ("project_kernel",)),
    ("binning", ("prep_kernel", "row_expand_kernel", "expand_kernel",
                 "bounds_gather_kernel")),
    ("blend", ("blend_kernel",)),
    ("sort", ("Radix", "radix", "Sort", "sort", "searchsorted")),
)
SORT_OPS = ("aten::sort", "aten::argsort", "aten::searchsorted")
#: the host op around the harness's own device work in a traced frame (the
#: copy of the frame's overflow flag); what it launches is left out
HARNESS_OP = "gsmbench_check"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")


def layer_of(kernel: str) -> str:
    for layer, keys in LAYER_KERNELS:
        if any(k in kernel for k in keys):
            return layer
    return "glue"


def short(name: str, n: int = 60) -> str:
    """A kernel's name without its return type, namespaces of PyTorch's
    own kernels and argument list, cut to ``n`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for prefix in ("at::native::", "at_cuda_detail::cub::"):
        name = name.replace(prefix, "")
    name = name.split("(")[0]
    return name if len(name) <= n else name[:n]


def trace_frames(frame, frames: int) -> dict:
    """Run ``frame(k)`` (each call renders and synchronises) for ``frames``
    frames under the profiler and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(frames):
            with record_function("frame"):
                frame(k)
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = reduce_events(events)
    out.update(frames=frames, window_s=window_s)
    return out


def reduce_events(events) -> dict:
    """Kernel seconds and launches by name, layer seconds, busy seconds (the
    union of device intervals), and idle gaps between device operations,
    each named by the innermost host op that launched the operation after
    it.  Device operations that ``HARNESS_OP`` launched are left out."""
    dev, runtime, host = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            dev.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                runtime[corr] = e
        elif cat in HOST_CATEGORIES and e.get("name") != "frame":
            host.append(e)
    dev.sort(key=lambda e: e["ts"])
    kernels, layers = {}, {}
    busy_us = 0.0
    launches = 0
    gaps = {}
    cur_end = None
    host.sort(key=lambda e: e["ts"])
    starts = [float(h["ts"]) for h in host]
    for e in dev:
        dur = float(e.get("dur", 0.0))
        s, t = float(e["ts"]), float(e["ts"]) + dur
        name = e["name"]
        around = _enclosing(runtime.get(e.get("args", {}).get("correlation")),
                            host, starts)
        if HARNESS_OP in around:
            continue
        launches += 1
        sec, n = kernels.get(name, (0.0, 0))
        kernels[name] = (sec + dur * 1e-6, n + 1)
        layer = layer_of(name) if e.get("cat") == "kernel" else "glue"
        if layer == "glue" and any(h in SORT_OPS for h in around):
            layer = "sort"
        layers[layer] = layers.get(layer, 0.0) + dur * 1e-6
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                label = (short(around[0], 40) if around else "host") \
                    + " -> " + short(name, 40)
                gaps[label] = gaps.get(label, 0.0) + (s - cur_end) * 1e-6
            busy_us += dur
            cur_end = t
        elif t > cur_end:
            busy_us += t - cur_end
            cur_end = t
    return dict(kernels=kernels, layers=layers, busy_s=busy_us * 1e-6,
                launches=launches, gaps=gaps)


def _enclosing(rt, host, starts) -> list:
    """Names of the host ops that run at the runtime call ``rt`` on its
    thread, innermost first (``host`` sorted by start, ``starts`` their
    starts)."""
    if rt is None:
        return []
    ts = float(rt["ts"])
    i = bisect.bisect_right(starts, ts) - 1
    return [h["name"] for h in host[max(i - 256, 0):i + 1][::-1]
            if h["ts"] + h.get("dur", 0.0) >= ts and h.get("tid") == rt.get("tid")]


def breakdown(tr: dict) -> dict:
    """The ten device operations that took most time and the ten largest
    idle totals by host activity, in seconds over the traced window."""
    ops = sorted(((short(k), v[0]) for k, v in tr["kernels"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, v] for k, v in ops],
                idle_gaps=[[k, v] for k, v in gaps])
