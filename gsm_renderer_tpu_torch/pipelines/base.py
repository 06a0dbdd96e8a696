"""Renderer base: device, instance capacity, validation, output format and
timing.

Port of ``gsm_renderer_tpu/pipelines/base.py``.  PyTorch runs eagerly, so
there is no program cache; the capacity contract is the JAX package's: the
first frame runs at the full model (4 x gaussians), the next frame reads the
previous frame's unclamped slot total once (the only host read of a frame)
and locks the capacity to 1.04 x that total, bucketed, re-reading every
``ADAPTIVE_REFRESH`` frames.  A frame whose demand exceeds its capacity
drops instances, sets ``header.overflow`` and still renders.  The row
decomposition's virtual-row capacity follows the same contract
(:meth:`GaussianRenderer.pick_row_capacity`).  Each host read counts in
``profiling.counters()`` as a lock-in or a refresh, and a refresh whose
demand exceeds the capacity in force as ``capacity_short``;
:meth:`GaussianRenderer.capacity_state` is the contract's state.
"""

from __future__ import annotations

import time

import torch

from .. import profiling
from ..config import INSTANCE_CAPACITY_FACTOR, ColorFormat, RendererConfig
from ..types import GaussianInput, RendererError, RenderOutput, resolve_device

ADAPTIVE_MARGIN = 1.04
ADAPTIVE_REFRESH = 64


def not_ported(what: str, item: str):
    """The error for an option of the JAX package that this package does not
    implement yet; ``item`` names its ROADMAP.md entry."""
    return NotImplementedError(
        f"{what} is not ported to gsm_renderer_tpu_torch yet (ROADMAP.md: {item})")


def instance_capacity(config: RendererConfig, n: int,
                      factor: int | None = None) -> int:
    """Static instance capacity: ``config.max_instances`` or ``factor`` x
    gaussians, floored at n + 1 (every gaussian owns a slot) and rounded up
    to a multiple of 4096."""
    if factor is None:
        factor = INSTANCE_CAPACITY_FACTOR
    c = config.max_instances if config.max_instances > 0 else factor * n
    c = max(c, n + 1)
    return -(-c // 4096) * 4096


def _count_read(state, total: int) -> None:
    """Count a capacity read: a lock-in where no capacity was in force,
    else a refresh, short where ``total`` exceeds the capacity in force."""
    profiling.count("host_reads")
    if state is None:
        profiling.count("capacity_lockins")
        return
    profiling.count("capacity_refreshes")
    if 0 < state["cap"] < total:
        profiling.count("capacity_short")


class GaussianRenderer:
    """Base renderer.  ``device`` defaults to the card; with no card the
    constructor raises unless the caller passes ``device="cpu"``."""

    def __init__(self, config: RendererConfig | None = None, *, device=None,
                 adaptive_capacity: bool = True):
        self.config = config or RendererConfig()
        self.device = resolve_device(device)
        self.adaptive_capacity = adaptive_capacity
        self.last_gpu_time: float | None = None
        self._cap_feedback: dict = {}
        self._cap_state: dict = {}

    def pick_capacity(self, n: int, factor: int | None = None,
                      kind: str = "mono") -> int:
        """Instance capacity for the next frame (see the module docstring).
        An explicit ``config.max_instances`` disables adaptation."""
        full = instance_capacity(self.config, n, factor)
        if not self.adaptive_capacity or self.config.max_instances > 0:
            return full
        state = self._cap_state.get((kind, n))
        if state is not None and state["age"] < ADAPTIVE_REFRESH:
            state["age"] += 1
            return state["cap"]
        fb = self._cap_feedback.get((kind, n))
        if fb is None or fb.slot_total is None:
            return full
        total = int(fb.slot_total)  # host read: once per lock-in / refresh
        _count_read(state, total)
        cap = int(total * ADAPTIVE_MARGIN) + 4096
        bucket = max(4096, 1 << max(cap.bit_length() - 5, 0))
        cap = max(min(-(-cap // bucket) * bucket, 4 * full), 4096)
        self._cap_state[(kind, n)] = {"cap": cap, "age": 0, "demand": total}
        return cap

    #: full-model factor of the virtual-row capacity of the row
    #: decomposition: every gaussian owns >= 1 row and an oversized rect owns
    #: rect_h rows
    ROW_CAPACITY_FACTOR = 2

    def pick_row_capacity(self, n: int, kind: str = "mono") -> int:
        """Virtual-row capacity for the next frame, with the margin, bucket
        and refresh of :meth:`pick_capacity`, sized from ``header.row_total``
        (read from the device once per lock-in / refresh).  Returns 0 -- run
        the full-rect expansion instead -- when the measured row demand
        exceeds 4x the full model."""
        full = -(-self.ROW_CAPACITY_FACTOR * n // 4096) * 4096
        if not self.adaptive_capacity:
            return full
        key = ("rows", kind, n)
        state = self._cap_state.get(key)
        if state is not None and state["age"] < ADAPTIVE_REFRESH:
            state["age"] += 1
            return state["cap"]
        fb = self._cap_feedback.get((kind, n))
        if fb is None or getattr(fb, "row_total", None) is None:
            return full
        total = int(fb.row_total)  # host read: once per lock-in / refresh
        _count_read(state, total)
        if total > 4 * full:
            cap = 0
        else:
            cap = int(total * ADAPTIVE_MARGIN) + 4096
            bucket = max(4096, 1 << max(cap.bit_length() - 5, 0))
            cap = max(min(-(-cap // bucket) * bucket, 4 * full), 4096)
        self._cap_state[key] = {"cap": cap, "age": 0, "demand": total}
        return cap

    def capacity_state(self) -> list:
        """The capacity contract's state: one dict for each capacity in
        force, with its ``kind`` (the frame kind, "<kind>.rows" for the
        virtual-row capacity), ``gaussians``, ``capacity`` (0: rows off),
        ``age`` (frames since it was read) and ``demand`` (the slot or row
        total that read found)."""
        out = []
        for key, st in sorted(self._cap_state.items(), key=repr):
            kind = f"{key[1]}.rows" if key[0] == "rows" else key[0]
            out.append(dict(kind=kind, gaussians=key[-1], capacity=st["cap"],
                            age=st["age"], demand=st["demand"]))
        return out

    def note_frame(self, n: int, header, kind: str = "mono") -> None:
        """Keep the frame's header as capacity feedback (no device read)."""
        if self.adaptive_capacity:
            self._cap_feedback[(kind, n)] = header

    def validate_inputs(self, gi: GaussianInput, width: int, height: int) -> None:
        gi.validate()
        c = self.config
        if gi.device.type != self.device.type:
            raise RendererError(
                f"gaussian input on {gi.device}, renderer on {self.device}")
        if gi.count > c.max_gaussians:
            raise RendererError(
                f"gaussian count {gi.count} exceeds config.max_gaussians "
                f"{c.max_gaussians}")
        if gi.count == 0:
            raise RendererError("empty gaussian input")
        if width <= 0 or height <= 0:
            raise RendererError(f"invalid render size {width}x{height}")
        if width > c.max_width or height > c.max_height:
            raise RendererError(
                f"render size {width}x{height} exceeds configured maximum "
                f"{c.max_width}x{c.max_height}")

    def finalize_output(self, out: RenderOutput) -> RenderOutput:
        """Apply ``config.color_format``: RGBA16_FLOAT quantizes color and
        depth to float16 once, after the float32 blend."""
        if self.config.color_format == ColorFormat.RGBA16_FLOAT:
            return RenderOutput(
                color=out.color.to(torch.float16),
                depth=None if out.depth is None else out.depth.to(torch.float16),
                header=out.header)
        return out

    def render(self, gi, camera, width: int, height: int) -> RenderOutput:
        raise NotImplementedError

    def render_stereo(self, gi, camera, width: int,
                      height: int) -> RenderOutput:
        raise NotImplementedError(
            f"{type(self).__name__} does not support stereo rendering")

    def render_timed(self, gi, camera, width: int, height: int) -> RenderOutput:
        """render() with its device time in ``last_gpu_time`` (seconds):
        CUDA events around the frame on the card, the host clock on the
        CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.render(gi, camera, width, height)
            end.record()
            end.synchronize()
            self.last_gpu_time = start.elapsed_time(end) / 1000.0
            return out
        t0 = time.perf_counter()
        out = self.render(gi, camera, width, height)
        self.last_gpu_time = time.perf_counter() - t0
        return out
