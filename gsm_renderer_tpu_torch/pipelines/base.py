"""Renderer base: device, instance capacity, validation, output format and
timing.

Port of ``gsm_renderer_tpu/pipelines/base.py``.  PyTorch runs eagerly, so
there is no program cache.  The capacity contract starts as the JAX
package's: the first frame runs at the full model (4 x gaussians), the next
frame reads the previous frame's unclamped slot total (a host read) and
locks the capacity to 1.04 x that total, bucketed, re-reading every
``ADAPTIVE_REFRESH`` frames, when it may shrink.  Between those reads it
follows the demand without waiting on the device: after each frame
(:meth:`GaussianRenderer.note_frame`) the slot total, and the row total
where the frame has one, are copied into pinned host memory behind the
frame's work, with an event recorded after the copies; the next pick reads
that copy only if its event is done, and where the demand it finds exceeds
1 / 1.04 of the capacity in force, grows the capacity to 1.04 x the demand
at once, bucketed as a lock-in is.  So the capacity trails the demand by
one frame when frames run one at a time, and a frame that still overflows
(its demand is that copy's total) makes the next pick grow.  A frame whose
demand exceeds its capacity drops instances, sets ``header.overflow`` and
still renders.  The row decomposition's virtual-row capacity follows the
same contract (:meth:`GaussianRenderer.pick_row_capacity`).  In
``profiling.counters()`` each host read counts as a lock-in or a refresh,
each growth between them as ``capacity_regrows``, and each read (refresh
or growth) whose demand exceeds the capacity in force -- a frame that
overflowed -- as ``capacity_short``; the picks and the copies run in the
frame's ``gsm::capacity`` spans; :meth:`GaussianRenderer.capacity_state`
is the contract's state.

Every public entry of every renderer renders through one path,
:meth:`GaussianRenderer.render_frame`: the entry gives its frame function
and the arguments that differ, the path does the rest.
"""

from __future__ import annotations

import time

import torch

from .. import profiling
from ..config import (INSTANCE_CAPACITY_FACTOR, ColorFormat,
                      GaussianColorSpace, RendererConfig)
from ..kernels.project import cached_projection_inputs
from ..profiling import span
from ..types import GaussianInput, RendererError, RenderOutput, resolve_device
from .common import used_sh_degree
from .replay import FrameGraphs

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


def _fit(total: int, full: int) -> int:
    """The capacity for a demand of ``total``: the margin and 4096 more,
    rounded up to a bucket of about 1/32 of it (small growth reuses the
    allocation), within [4096, 4 x ``full``]."""
    cap = int(total * ADAPTIVE_MARGIN) + 4096
    bucket = max(4096, 1 << max(cap.bit_length() - 5, 0))
    return max(min(-(-cap // bucket) * bucket, 4 * full), 4096)


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


class _Demand:
    """A frame's slot total and row total (None where the frame has none)
    on their way to the host: 0-d views of a pinned buffer that the copies
    behind the frame's work fill, and the event recorded after them."""

    __slots__ = ("slot_total", "row_total", "event")

    def __init__(self, rows: bool):
        buf = torch.zeros(2, dtype=torch.int32, pin_memory=True)
        self.slot_total = buf[0]
        self.row_total = buf[1] if rows else None
        self.event = torch.cuda.Event()


class GaussianRenderer:
    """Base renderer.  ``device`` defaults to the card; with no card the
    constructor raises unless the caller passes ``device="cpu"``."""

    #: render every frame eagerly: no CUDA graph (tests compare the two)
    _eager_frames = False

    def __init__(self, config: RendererConfig | None = None, *, device=None,
                 adaptive_capacity: bool = True):
        self.config = config or RendererConfig()
        self.device = resolve_device(device)
        self.adaptive_capacity = adaptive_capacity
        self.last_gpu_time: float | None = None
        self._cap_feedback: dict = {}
        self._cap_state: dict = {}
        self._graphs = FrameGraphs(self.device)

    def render_frame(self, kind: str, gi, width: int, height: int, frame,
                     kw: dict, *, factor: int | None = None,
                     rows: bool | None = None, prepare=None, pose=None,
                     stereo: bool = False, graphable=None,
                     output=None) -> RenderOutput:
        """The path of every public entry: the frame function ``frame`` of
        capacity kind ``kind`` on ``gi`` at a ``width`` x ``height`` size,
        given the entry's own keyword arguments ``kw``, which it completes.

        1. ``gsm::entry``: the inputs' validation, the SH degree,
           ``prepare()``'s keyword arguments (the foveated tables) and the
           cached projection inputs;
        2. the capacities of ``kind`` (``factor``: the full model's;
           ``rows``: with the virtual-row capacity, the frame's
           ``row_capacity``; None: the frame takes none);
        3. ``frame(prepared=..., **kw)``, ``kw`` given the capacities, the
           SH degree and the config's thresholds and colour space:
           replayed or eager (``FrameGraphs.render``, given ``pose``,
           ``stereo`` and ``graphable``; no ``pose``: eager);
        4. the frame's demand kept as capacity feedback (:meth:`note_frame`);
        5. ``gsm::output``: ``output(out)`` where given, then the output
           format (:meth:`finalize_output`)."""
        c = self.config
        n = gi.count
        with span("entry"):
            self.validate_inputs(gi, width, height)
            sh_degree = used_sh_degree(c, gi)
            if prepare is not None:
                kw.update(prepare())
            prepared = cached_projection_inputs(gi, sh_degree)
        capacity, row_capacity = self.pick_capacities(n, kind, factor,
                                                      rows=bool(rows))
        kw.update(capacity=capacity, sh_degree=sh_degree,
                  alpha_threshold=c.alpha_threshold,
                  total_ink_threshold=c.total_ink_threshold,
                  input_is_srgb=c.gaussian_color_space
                  == GaussianColorSpace.SRGB)
        if rows is not None:
            kw["row_capacity"] = row_capacity
        out = self._graphs.render(
            kind, frame, kw, prepared, pose=pose, stereo=stereo,
            graphable=graphable, scan_elements=max(n, row_capacity),
            eager=self._eager_frames)
        self.note_frame(n, out.header, kind=kind)
        with span("output"):
            return self.finalize_output(out if output is None
                                        else output(out))

    def _follow(self, key, kind: str, n: int, field: str, size,
                full: int) -> int:
        """The capacity under ``key`` for the next frame of ``kind`` and
        ``n`` gaussians (see the module docstring): the full model
        ``full`` before any feedback; a lock-in or refresh (a host read,
        which waits for the last frame's copy) where none is in force or
        it is ``ADAPTIVE_REFRESH`` frames old; else the capacity in force,
        grown to ``size(demand)`` where the last copy, once its event is
        done, shows the demand over 1 / ADAPTIVE_MARGIN of it.  ``field``
        names the feedback's demand: "slot_total" or "row_total"."""
        state = self._cap_state.get(key)
        fb = self._cap_feedback.get((kind, n))
        value = getattr(fb, field, None)
        event = getattr(fb, "event", None)
        if state is not None and state["age"] < ADAPTIVE_REFRESH:
            state["age"] += 1
            cap = state["cap"]
            if value is not None and cap > 0 and (event is None
                                                  or event.query()):
                total = int(value)  # the copy is done: no wait
                grown = size(total) if total * ADAPTIVE_MARGIN > cap else cap
                if grown != cap:
                    profiling.count("capacity_regrows")
                    if total > cap:
                        profiling.count("capacity_short")
                    state.update(cap=grown, demand=total)
            return state["cap"]
        if value is None:
            return full
        if event is not None:
            event.synchronize()
        total = int(value)  # host read: once per lock-in / refresh
        _count_read(state, total)
        self._cap_state[key] = {"cap": size(total), "age": 0, "demand": total}
        return self._cap_state[key]["cap"]

    def pick_capacity(self, n: int, factor: int | None = None,
                      kind: str = "mono") -> int:
        """Instance capacity for the next frame (see the module docstring).
        An explicit ``config.max_instances`` disables adaptation."""
        full = instance_capacity(self.config, n, factor)
        if not self.adaptive_capacity or self.config.max_instances > 0:
            return full
        return self._follow((kind, n), kind, n, "slot_total",
                            lambda total: _fit(total, full), full)

    #: full-model factor of the virtual-row capacity of the row
    #: decomposition: every gaussian owns >= 1 row and an oversized rect owns
    #: rect_h rows
    ROW_CAPACITY_FACTOR = 2

    def pick_row_capacity(self, n: int, kind: str = "mono") -> int:
        """Virtual-row capacity for the next frame, with the margin, bucket,
        refresh and growth of :meth:`pick_capacity`, sized from
        ``header.row_total``.  Returns 0 -- run the full-rect expansion
        instead -- when the measured row demand exceeds 4x the full model;
        rows switched off stay off until the next refresh."""
        full = -(-self.ROW_CAPACITY_FACTOR * n // 4096) * 4096
        if not self.adaptive_capacity:
            return full

        def size(total):
            return 0 if total > 4 * full else _fit(total, full)

        return self._follow(("rows", kind, n), kind, n, "row_total", size,
                            full)

    def pick_capacities(self, n: int, kind: str, factor: int | None = None,
                        rows: bool = False) -> tuple:
        """(instance capacity, virtual-row capacity: 0 without ``rows``) of
        the next frame of ``kind``, picked in the frame's
        ``gsm::capacity`` span."""
        with profiling.span("capacity"):
            row_cap = self.pick_row_capacity(n, kind=kind) if rows else 0
            return self.pick_capacity(n, factor, kind=kind), row_cap

    def capacity_state(self) -> list:
        """The capacity contract's state: one dict for each capacity in
        force, with its ``kind`` (the frame kind, "<kind>.rows" for the
        virtual-row capacity), ``gaussians``, ``capacity`` (0: rows off),
        ``age`` (frames since its lock-in or refresh) and ``demand`` (the
        slot or row total that set it: that read's, or a growth's)."""
        out = []
        for key, st in sorted(self._cap_state.items(), key=repr):
            kind = f"{key[1]}.rows" if key[0] == "rows" else key[0]
            out.append(dict(kind=kind, gaussians=key[-1], capacity=st["cap"],
                            age=st["age"], demand=st["demand"]))
        return out

    def note_frame(self, n: int, header, kind: str = "mono") -> None:
        """Keep the frame's slot and row totals as capacity feedback, in
        the frame's ``gsm::capacity`` span and without a device read: on
        the card, copied into pinned host memory behind the frame's work,
        an event recorded after the copies; on the CPU, the header."""
        if not self.adaptive_capacity:
            return
        with profiling.span("capacity"):
            total = header.slot_total
            rows = getattr(header, "row_total", None)
            if not (torch.is_tensor(total) and total.is_cuda):
                self._cap_feedback[(kind, n)] = header
                return
            fb = self._cap_feedback.get((kind, n))
            if not isinstance(fb, _Demand) or (
                    (fb.row_total is None) != (rows is None)):
                fb = self._cap_feedback[(kind, n)] = _Demand(rows is not None)
            fb.slot_total.copy_(total, non_blocking=True)
            if rows is not None:
                fb.row_total.copy_(rows, non_blocking=True)
            fb.event.record()

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
