"""Host-clock statistics and the host/device split of a frame."""

from __future__ import annotations

import time

import torch


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` a millisecond, by CUDA events."""
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def frame_split(frames_fn, frames: int, cycles_per_ms: float) -> dict:
    """Host and device time of a frame, apart.  ``host_ms``: the host's time
    to enqueue one frame while a sleep kernel holds the device, so that it
    never waits on the device; ``device_ms``: the device time a frame of
    those frames, which run back to back behind the sleep.  ``host_ahead``
    is false where the host waited on the device (a host read, or a full
    launch queue): the split is then not valid.  ``frames_fn(k)`` renders
    the k-th frame of the split without synchronising."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames_fn(0)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (2.0 * frames * one_ms + 1.0)))
    start.record()
    t0 = time.perf_counter()
    for k in range(frames):
        frames_fn(k + 1)
    host_ms = (time.perf_counter() - t0) * 1e3 / frames
    ahead = not start.query()
    end.record()
    end.synchronize()
    return dict(host_ms=host_ms, device_ms=start.elapsed_time(end) / frames,
                host_ahead=ahead)
