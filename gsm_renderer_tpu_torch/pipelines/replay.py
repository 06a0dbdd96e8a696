"""Captured frames: one CUDA graph a frame kind, replayed while the values
it bakes in stay the same.

Between capacity changes a DepthFirst mono, side-by-side or foveated
stereo frame launches the same kernels on buffers of the same sizes every
frame, and reads nothing from the device; only the camera changes.  So the
frame's whole chain -- the projection, a foveated frame's re-bin, prep
(which writes the header's sums), row expand, expand, key pack, sort,
ranges (and the counts' sum), blend and their torch glue -- is captured
once into a ``torch.cuda.CUDAGraph`` and replayed for every later frame
under the same key, each replay one graph launch where the eager frame has
about forty.  The camera travels as it does eagerly, by value in the
projection's launch: before each replay the host writes the frame's pose
block into the instantiated graph's projection node
(``kernels/project.py::set_pose``).  The update takes effect at the next
launch and leaves launches already queued as they were, so frames queued
back to back each render their own camera, and the host waits for nothing.

The key (:func:`frame_key`) holds every host value that a capture bakes
into its launches, the pose block apart: the frame kind, the storage of the
projection inputs, the frame function's arguments (size, capacities, near
and far and so the KeyPlan, the config fields it reads; a foveated
target's device tables, equal only to themselves, which the key holds),
the blend's early-exit transmittance and whether spans record (a graph captured with
spans holds their timing events).  A frame kind keeps one graph, replaced
when the key changes; the old graph's outputs are freed before the new
capture, so that they do not add to its peak memory.  A frame renders
eagerly on the CPU, where the renderer's ``_eager_frames`` is set (tests
compare the two), where its entry gives no pose block (the Global and
Local frames), where its entry says it may not be captured (16-bit depth
keys, the stable fallback), and as the first frame of its kind, so that
every library and kernel it reaches is loaded before a capture.

A capture runs on a side stream of the renderer and waits for nothing: it
records the launches without running them, then the frame replays at once
on the caller's stream.  Every graph of the renderer allocates from one
memory pool, so that a re-capture reuses the memory of the graph it
replaces instead of taking more from the device; the graph being replaced
lives until the new capture has begun, so that the pool always has an
owner.  Sharing is safe because a replay writes every buffer of its frame
before it reads it, and its outputs are copied before any other graph
replays: no graph relies on what its memory held before its launch.  The
look-back scratch of the prep and row-expand scans (``kernels/expand.py``)
is kept per stream: the side stream's pair is sized before the capture, so
that no launch inside replaces it, and the graph keeps it, with the inputs
it reads, for as long as it lives.

A replay writes its colour and depth into tensors of its own, as an eager
frame does, so that a later frame never overwrites what a caller holds:
right after each launch, while the device works, the host allocates the
next frame's and points the graph's blend launches at them
(``kernels/blend.py::set_outputs``); the header's few counters are copied
out.  Counters and spans (``profiling.py``): a capture counts
``graph_captures`` and nothing it launched; a replay counts
``graph_replays`` with the launches and counters of its capture, and, while
spans record, adds the capture's stage spans to its frame under a
``gsm::replay`` span, timed by the graph's event-record nodes.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import profiling
from ..kernels import blend as KB
from ..kernels.blend import find_output_nodes, set_outputs
from ..kernels.expand import scan_scratch
from ..kernels.project import find_pose_node, set_pose
from ..profiling import span
from ..types import FrameHeader, RenderOutput


class _Graph:
    """A captured frame: its key, the graph and its instantiated graph
    (``cudaGraphExec_t``), its projection node and blend launches, the
    header it writes and the shapes of its colour and depth (None: no
    depth), what the capture recorded (``profiling.Capture``), what the
    graph reads and must outlive, the outputs of its next replay, and the
    spans of its last replay whose times are still to read."""

    __slots__ = ("key", "graph", "exec", "node", "outputs", "header",
                 "shapes", "capture", "keep", "next", "pending")

    def __init__(self, key, graph, stereo, out, capture, keep):
        self.key, self.graph = key, graph
        self.exec = graph.raw_cuda_graph_exec()
        self.node = find_pose_node(graph.raw_cuda_graph(), stereo)
        self.outputs = find_output_nodes(graph.raw_cuda_graph(), out.color)
        self.header = out.header
        self.shapes = (out.color.shape,
                       None if out.depth is None else out.depth.shape)
        self.capture, self.keep = capture, keep
        self.next = self.new_outputs()
        self.pending = []

    def new_outputs(self):
        """New colour and depth tensors, which the graph's next launches
        write."""
        color, depth = (None if shape is None else
                        torch.empty(shape, dtype=torch.float32,
                                    device=self.header.overflow.device)
                        for shape in self.shapes)
        set_outputs(self.exec, self.outputs, color, depth)
        return color, depth


#: the frame arguments a pose block's frame constants are made of
POSE_ARGS = ("width", "height", "near_plane", "far_plane", "alpha_threshold",
             "total_ink_threshold")


def pose_args(kw: dict) -> dict:
    """The frame arguments ``kw``'s POSE_ARGS: the projection's size is a
    foveated frame's display size."""
    if "display_width" not in kw:
        return {k: kw[k] for k in POSE_ARGS}
    return dict({k: kw[k] for k in POSE_ARGS[2:]}, width=kw["display_width"],
                height=kw["display_height"])


def frame_key(kind: str, kw: dict, prepared) -> tuple:
    """The graph key of a frame of ``kind`` (see the module docstring):
    the frame function's keyword arguments ``kw`` (all but the pose; a
    foveated target's device tables compare by identity, ``depth_first.
    DeviceTables``), the storage of the projection inputs ``prepared``,
    the blend's early-exit transmittance (a module value that callers set
    to 0 to render without the exit) and whether spans record."""
    return (kind, tuple(kw.items()), KB.MIN_TRANSMITTANCE, profiling.active(),
            *((t.data_ptr(), *t.shape) for t in prepared))


def copy_header(h: FrameHeader) -> FrameHeader:
    """A new header holding ``h``'s counters: stacked into one int32
    tensor, whose elements it holds."""
    names = [f.name for f in dataclasses.fields(h)
             if getattr(h, f.name) is not None]
    values = torch.stack([getattr(h, name) for name in names])
    return FrameHeader(**{name: values[i] for i, name in enumerate(names)})


class FrameGraphs:
    """The frames of a renderer on ``device``: eager, or on the card
    replayed from at most one graph a frame kind (see the module
    docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: dict = {}
        self._warm: set = set()
        self._stream = self._pool = None

    def render(self, kind: str, frame, kw: dict, prepared, *, pose=None,
               stereo: bool = False, graphable=None, scan_elements: int = 0,
               eager: bool = False) -> RenderOutput:
        """The frame ``frame(prepared=prepared, **kw)`` of ``kind``: on the
        card the replay of the kind's graph under :func:`frame_key`, its
        projection given the pose block ``pose(**pose_args(kw))``
        (``stereo``: the dual-eye projection's), captured first where the
        key is new and ``graphable()``; eager on the CPU, with ``eager``,
        without ``pose``, where the key is new and not ``graphable()``, and
        where the kind has not rendered yet.  ``prepared``: the projection
        inputs, which the graph keeps; ``scan_elements``: the most elements
        a prep or row-expand scan of the frame covers."""
        if pose is None or eager or self.device.type != "cuda":
            return frame(prepared=prepared, **kw)
        key = frame_key(kind, kw, prepared)
        g = self._graphs.get(kind)
        if g is None or g.key != key:
            if kind not in self._warm or not graphable():
                self._warm.add(kind)
                return frame(prepared=prepared, **kw)
            if g is not None:
                g.next = None  # its memory serves the new capture
            try:
                g = self._capture(key, lambda: frame(prepared=prepared, **kw),
                                  stereo, prepared, scan_elements)
            except BaseException:
                self._graphs.pop(kind, None)
                raise
            self._graphs[kind] = g
        return self._replay(g, pose(**pose_args(kw)))

    def _capture(self, key, render, stereo, keep, scan_elements) -> _Graph:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # the renderer's pool, while a graph of it lives to own it
        pool = self._pool if self._graphs else None
        with torch.cuda.stream(self._stream):
            scratch = scan_scratch(self.device, scan_elements)
            with profiling.capturing() as rec:
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = render()
                except BaseException:
                    # a capture left open keeps its stream and pool
                    # recording: the next capture takes new ones
                    self._stream = self._pool = None
                    _end_failed_capture(graph)
                    raise
                graph.capture_end()
        self._pool = graph.pool()
        graph.instantiate()
        # the replays run on the caller's stream: after the scratch is
        # zeroed, and before its memory serves another allocation
        caller.wait_stream(self._stream)
        for t in scratch:
            t.record_stream(caller)
        # the graph's own colour and depth are freed here: every launch
        # writes tensors of its frame's (_Graph.new_outputs)
        return _Graph(key, graph, stereo, out, rec, (keep, scratch))

    def _replay(self, g: _Graph, pose) -> RenderOutput:
        # the last replay's span times, before the graph records its
        # events again (pending only while spans record)
        profiling.settle(g.pending)
        with span("replay"):
            t0 = time.perf_counter_ns()
            color, depth = g.next
            set_pose(g.exec, g.node, pose)
            g.graph.replay()
            g.next = g.new_outputs()
            header = copy_header(g.header)
            g.pending = profiling.replayed(g.capture, t0, header)
        return RenderOutput(color=color, depth=depth, header=header)


def _end_failed_capture(graph) -> None:
    """End a capture that a raise interrupted, so that the stream leaves
    capture mode; the capture's own error, if any, yields to the raise."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
