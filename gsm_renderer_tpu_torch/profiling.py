"""Spans and counters of the port's frames.

Port of ``gsm_renderer_tpu/profiling.py``, built on the frames the renderers
really render rather than on a copy of their chain.

**Spans.**  ``span(name)`` marks one stage of a frame.  It records only
while a ``torch.profiler`` session is active or after ``enable(True)``;
otherwise it returns one shared no-op context, after one call into torch
and a module flag.  An active span enters ``record_function("gsm::<name>")``
while the profiler runs, so that the range lies on the profiler's timeline
beside the device records it launched, and adds to the open frame's record
its host interval (``time.perf_counter_ns``) and, on CUDA, a pair of timing
events recorded on the stream that was current when the frame opened.  It launches no device work and
reads nothing from the device: the events are read when :func:`frames`
reads the record.  The renderers' public entries open the frame
(:func:`traced_frame`, span ``gsm::frame``); a span outside any frame (the
band frame of ``parallel/multichip.py``) goes to the profiler alone.  The
last ``RING`` frames are kept.  A frame's stages, in order::

    frame
      entry      validation, the projection-input cache
      capacity   the capacity picks, their lock-in and refresh host reads
                 and their growth (pipelines/base.py)
      replay     a captured frame's graph launch and the copy of its
                 outputs (pipelines/replay.py); the stages below it are
                 the graph's, timed by its event-record nodes
      project
      rebin      foveated frames: the re-binning onto the physical tiles
                 (one kernel on the card)
      binning    prep, row_expand (rows on), expand
      sort       the key pack and the keys-only sort (the stable
                 fallback: torch.sort with its permutation)
      ranges     the tile ranges, a per-tile clamp
      blend      blend and assemble
      header     the header, read from the kernels' records of its sums
                 (on the CPU the plain versions sum in prep and ranges)
      capacity   the copies of the frame's demand to the host
      output     the output format

Every device operation a frame launches is launched inside one of its stage
spans.  Spans record the frames of one rendering thread.

**Counters** (:func:`counters`): frames rendered through a public entry,
instance sorts by path (keys-only under a KeyPlan, or the stable
fallback) and CUB's radix passes on the card, frames by where their
header's sums came from (the kernels' records, or torch sums of the plain
versions on the CPU), foveated frames by how they re-binned onto the
physical tiles (the kernel, or the plain torch chain on the CPU),
hand-kernel launches (``_native.Kernel.launches`` summed), host reads,
capacity lock-ins, refreshes, growths between refreshes and reads that
found the demand above the capacity in force (``pipelines/base.py``),
overflowed frames among the recorded ones, CUDA graph captures and
replays of frames (``pipelines/replay.py``), and the set-up seconds of the
kernel build and load and of the projection-input cache.  A recorded frame
keeps the counters that moved while it rendered.

**Captured frames.**  While a frame is captured into a CUDA graph
(:func:`capturing`) its launches are recorded, not run: the counters and
launch counts it moved are taken back and kept, and each replay
(:func:`replayed`) counts them again.  While spans record, the capture's
stage spans record their timing events as the graph's event-record nodes,
and each replay adds the spans to the open frame with those events; their
times are read (:func:`settle`) before the next replay records the events
again.

**Stage split.**  The JAX package's ``profile_depth_first_stages`` splits
a frame of its own by stage; here the spans of the frames the renderers
render are the split: ``enable(True)``, render, then :func:`frames` gives
each frame's stages with their host and device times.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch

#: recorded frames kept
RING = 256

_profiler_enabled = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_enabled = False
_ring: collections.deque = collections.deque(maxlen=RING)
_open = None  # the _Frame being recorded
_next_id = 0
_COUNTS = dict(frames=0, sort_keys_only=0, sort_stable=0,
               sort_radix_passes=0, header_sums_kernel=0, header_sums_torch=0,
               rebin_kernel=0, rebin_torch=0, host_reads=0, capacity_lockins=0,
               capacity_refreshes=0, capacity_regrows=0, capacity_short=0,
               graph_captures=0, graph_replays=0)
_SETUP = dict(kernel_build_s=0.0, kernel_load_s=0.0, projection_cache_s=0.0)


def enable(on: bool = True) -> None:
    """Record spans without a profiler session (on) or only under one
    (off, the default)."""
    global _enabled
    _enabled = bool(on)


def active() -> bool:
    """Whether spans record now."""
    return _enabled or _profiler_enabled()


class _Frame:
    __slots__ = ("id", "cuda", "capture", "stream", "spans", "stack",
                 "overflow", "slot_total", "capacity", "counts")

    def __init__(self, frame_id: int, cuda: bool, capture: bool = False):
        # capture: the spans of a frame being captured into a CUDA graph,
        # whose events are the graph's event-record nodes
        self.id, self.cuda, self.capture = frame_id, cuda, capture
        # the events' stream, looked up once: torch.cuda.current_stream()
        # costs several times an event record on the host
        self.stream = torch.cuda.current_stream() if cuda else None
        self.spans, self.stack = [], []
        self.overflow = self.slot_total = self.capacity = None
        # the counters when the frame opened; when it closed, those that
        # moved, by how much
        self.counts = dict(_COUNTS)


class _Span:
    __slots__ = ("name", "parent", "frame", "rf", "t0", "t1", "ev0", "ev1",
                 "ms")

    def __init__(self, name: str):
        self.name = name
        self.parent = self.frame = self.rf = None
        self.ev0 = self.ev1 = None
        self.ms = None  # the device ms, once read from the events

    def __enter__(self):
        if _profiler_enabled():
            self.rf = torch.profiler.record_function("gsm::" + self.name)
            self.rf.__enter__()
        fr = _open
        if fr is not None:
            self.frame = fr
            if fr.stack:
                self.parent = fr.stack[-1].name
            fr.stack.append(self)
            fr.spans.append(self)
            if fr.cuda:
                self.ev0 = torch.cuda.Event(enable_timing=True,
                                            external=fr.capture)
                self.ev0.record(fr.stream)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        fr = self.frame
        if fr is not None:
            self.t1 = time.perf_counter_ns()
            if fr.cuda:
                self.ev1 = torch.cuda.Event(enable_timing=True,
                                            external=fr.capture)
                self.ev1.record(fr.stream)
            fr.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _FrameSpan(_Span):
    """The ``gsm::frame`` span: opens a frame record on ``device`` and
    keeps it in the ring when it closes."""

    __slots__ = ("device",)

    def __init__(self, device):
        super().__init__("frame")
        self.device = torch.device(device)

    def __enter__(self):
        global _open, _next_id
        _open = _Frame(_next_id, self.device.type == "cuda")
        _next_id += 1
        return super().__enter__()

    def __exit__(self, *exc):
        global _open
        super().__exit__(*exc)
        fr = self.frame
        fr.counts = {k: _COUNTS[k] - v for k, v in fr.counts.items()
                     if _COUNTS[k] != v}
        _ring.append(fr)
        _open = None
        return False


def span(name: str):
    """The context of stage ``name`` (recorded as ``gsm::<name>``); a
    shared no-op context while spans do not record."""
    if not (_enabled or _profiler_enabled()):
        return _NOOP
    return _Span(name)


def traced_frame(render):
    """Decorator of a renderer's public entry: counts the frame and, while
    spans record, renders it inside its ``gsm::frame`` span."""

    @functools.wraps(render)
    def entry(self, *args, **kwargs):
        _COUNTS["frames"] += 1
        if not (_enabled or _profiler_enabled()) or _open is not None:
            return render(self, *args, **kwargs)
        with _FrameSpan(self.device):
            return render(self, *args, **kwargs)

    return entry


def note_header(header, capacity: int) -> None:
    """Keep the open frame's overflow flag, unclamped slot total (0-d
    tensors, read when the counters are) and instance capacity."""
    fr = _open
    if fr is not None:
        fr.overflow, fr.slot_total = header.overflow, header.slot_total
        fr.capacity = capacity


def count(name: str, amount: int = 1) -> None:
    """Count ``amount`` events of ``name`` (a sort by its path, its radix
    passes, a host read, the capacity contract's events)."""
    _COUNTS[name] += amount


def add_setup(name: str, seconds: float) -> None:
    """Add ``seconds`` to set-up timer ``name``."""
    _SETUP[name] += seconds


class Capture:
    """What a frame captured into a CUDA graph recorded: ``spans``, its
    stage spans, whose events the graph records on each replay (empty
    while spans do not record); ``counts`` and ``launches``, the counter
    moves and the launches (``_native.Kernel``, count) that each replay
    repeats; ``capacity``, the capacity its header noted."""

    __slots__ = ("spans", "counts", "launches", "capacity")


@contextlib.contextmanager
def capturing():
    """The context of a frame's capture into a CUDA graph, on the
    capturing stream: yields a :class:`Capture`, filled when the context
    closes.  The counters and launch counts the capture moved are taken
    back (a replay counts them) and ``graph_captures`` counts one; while a
    frame records, the capture's spans go to the Capture."""
    from . import _native

    global _open
    outer = _open
    rec = Capture()
    fr = None if outer is None else _Frame(-1, True, capture=True)
    counts = dict(_COUNTS)
    launches = [k.launches for k in _native.KERNELS]
    _open = fr
    try:
        yield rec
    finally:
        _open = outer
        rec.counts = {k: _COUNTS[k] - v for k, v in counts.items()
                      if _COUNTS[k] != v}
        _COUNTS.update(counts)
        _COUNTS["graph_captures"] += 1
        rec.launches = [(k, k.launches - n)
                        for k, n in zip(_native.KERNELS, launches)
                        if k.launches != n]
        for k, n in zip(_native.KERNELS, launches):
            k.launches = n
        rec.spans = [] if fr is None else fr.spans
        rec.capacity = None if fr is None else fr.capacity


def replayed(rec: Capture, t0: int, header) -> list:
    """Count a replay of the captured frame ``rec``, launched at host time
    ``t0`` (``time.perf_counter_ns``): ``graph_replays``, and the counters
    and launches of the capture.  While a frame records, add the
    capture's stage spans to it under the open span, timed by the graph's
    events, and note ``header`` (the replay's copy) with the capture's
    capacity.  Returns the spans added, for :func:`settle` before the next
    replay."""
    _COUNTS["graph_replays"] += 1
    for k, v in rec.counts.items():
        _COUNTS[k] += v
    for kernel, n in rec.launches:
        kernel.launches += n
    fr = _open
    if fr is None:
        return []
    outer = fr.stack[-1].name if fr.stack else None
    added = []
    for s in rec.spans:
        r = _Span(s.name)
        r.frame, r.parent = fr, outer if s.parent is None else s.parent
        r.t0 = r.t1 = t0
        r.ev0, r.ev1 = s.ev0, s.ev1
        added.append(r)
    fr.spans += added
    note_header(header, rec.capacity)
    return added


def settle(spans) -> None:
    """Read the device ms of replayed ``spans`` from their events (a wait
    for the device), before a replay records the events again.  The last
    span closed last: its end is the replay's last event."""
    if spans:
        spans[-1].ev1.synchronize()
    for s in spans:
        s.ms = s.ev0.elapsed_time(s.ev1)
        s.ev0 = s.ev1 = None


def _read(fr: _Frame) -> dict:
    spans = []
    for s in fr.spans:
        host = (s.t1 - s.t0) * 1e-6
        if s.ms is not None:
            device = s.ms
        elif fr.cuda:
            s.ev1.synchronize()
            device = s.ev0.elapsed_time(s.ev1)
        else:
            device = host
        spans.append(dict(name=s.name, parent=s.parent, host_ms=host,
                          device_ms=device))
    first = next((s for s in fr.spans if s.name == "project"), None)
    return dict(
        id=fr.id, spans=spans,
        entry_ms=None if first is None
        else (first.t0 - fr.spans[0].t0) * 1e-6,
        capacity=fr.capacity,
        slot_total=None if fr.slot_total is None else int(fr.slot_total),
        overflow=None if fr.overflow is None else int(fr.overflow),
        counters=dict(fr.counts))


def frames() -> list:
    """The recorded frames, oldest first.  Each: ``id``; ``spans``, in the
    order they opened, each with its ``name``, ``parent`` (the enclosing
    span's name; None for ``frame``), ``host_ms`` and ``device_ms`` (the
    stream interval between its markers, which includes any wait for the
    host inside it; on the CPU the host interval); ``entry_ms``, host ms
    from the frame's start to the projection's (the program's work before
    its first kernel; None without a projection); the frame's
    ``capacity``, unclamped ``slot_total`` and ``overflow`` (None where the
    frame made no header); and ``counters``, those of :func:`counters`'
    event counts that moved while the frame rendered (such as
    ``capacity_regrows``), by how much.  Waits for the recorded frames'
    device work."""
    return [_read(fr) for fr in _ring]


def reset() -> None:
    """Forget the recorded frames."""
    _ring.clear()


def counters() -> dict:
    """A snapshot of the counters: ``frames`` (through a public entry),
    ``sort_keys_only`` and ``sort_stable`` (instance sorts, a frame's or a
    band's, by path: the KeyPlan's keys-only sort or the stable fallback),
    ``sort_radix_passes`` (the passes over the keys that CUB's radix sort
    makes, summed over its sorts on the card; the CPU's plain sort makes
    none: on the card, divided by ``sort_keys_only``, the passes a sort),
    ``header_sums_kernel`` and ``header_sums_torch`` (frames whose header
    sums came from the kernels' records -- prep's sums, the ranges' counts
    total -- or from torch sums of the plain versions, which CPU frames
    take), ``rebin_kernel`` and ``rebin_torch`` (foveated frames whose
    re-bin onto the physical tiles ran the kernel, or the plain torch
    chain, which CPU frames take), ``kernel_launches``, ``host_reads``,
    ``capacity_lockins``, ``capacity_refreshes``, ``capacity_regrows``
    (growths between refreshes, from the pinned copy of a frame's demand),
    ``capacity_short`` (refresh or growth reads whose demand exceeded the
    capacity in force: frames that overflowed, as far as a read saw
    them), ``graph_captures`` and ``graph_replays`` (frames captured into
    and replayed from CUDA graphs; a replay counts the launches of its
    capture in ``kernel_launches``), ``overflow_frames`` (among the
    recorded frames; reads their flags from the device),
    ``kernel_build_s``, ``kernel_load_s`` and ``projection_cache_s``."""
    from . import _native

    return dict(
        frames=_COUNTS["frames"],
        sort_keys_only=_COUNTS["sort_keys_only"],
        sort_stable=_COUNTS["sort_stable"],
        sort_radix_passes=_COUNTS["sort_radix_passes"],
        header_sums_kernel=_COUNTS["header_sums_kernel"],
        header_sums_torch=_COUNTS["header_sums_torch"],
        rebin_kernel=_COUNTS["rebin_kernel"],
        rebin_torch=_COUNTS["rebin_torch"],
        kernel_launches=sum(k.launches for k in _native.KERNELS),
        host_reads=_COUNTS["host_reads"],
        capacity_lockins=_COUNTS["capacity_lockins"],
        capacity_refreshes=_COUNTS["capacity_refreshes"],
        capacity_regrows=_COUNTS["capacity_regrows"],
        capacity_short=_COUNTS["capacity_short"],
        graph_captures=_COUNTS["graph_captures"],
        graph_replays=_COUNTS["graph_replays"],
        overflow_frames=sum(int(fr.overflow) for fr in _ring
                            if fr.overflow is not None),
        **_SETUP)
