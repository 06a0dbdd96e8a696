"""gsm_renderer_tpu_torch.profiling: the frame-stage spans and the counters.

On the CPU (plain versions; times here are host-clock times, not device
metrics): spans are off by default and cost no ``record_function``; every
public entry of every renderer records the stage tree in frame order, and
under ``torch.profiler`` every ``aten::`` op of a frame lies inside a
``gsm::`` stage span; the capacity contract's counters; the re-bin's
counters by path; the benchmark's span readers against
``profiling.frames()``.  On the card (marked ``card``): the launch counter
against the hand kernels a traced frame shows, and the re-bin's counters
there.  This file imports no JAX, so that
``python -m pytest --noconftest tests/test_torch_tracing.py`` runs it on a
machine with a card and without JAX."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
from gsm_renderer_tpu_torch.pipelines import base

W, H = 64, 48
FOV = dict(min_rate=0.4, radius=0.3)
#: the stage spans a frame of each entry records, in order (a repeated
#: stage, such as Local's clamp after the ranges, counts once); the
#: capacity contract's span after the entry (the picks) and after the
#: header (the copies of the frame's demand)
BINNING = ["binning", "prep", "expand", "sort", "ranges", "blend", "header"]
HEAD = ["frame", "entry", "capacity", "project"]
TAIL = ["capacity", "output"]
TREES = {
    "rows": [*HEAD, "binning", "prep", "row_expand", "expand", "sort",
             "ranges", "blend", "header", *TAIL],
    "rows_off": [*HEAD, *BINNING, *TAIL],
    "stereo": [*HEAD, *BINNING, *TAIL],
    "foveated": [*HEAD, "rebin", *BINNING, *TAIL],
    "compress": [*HEAD, *BINNING, *TAIL],
    "hardware": [*HEAD, *BINNING, *TAIL],
    "global": [*HEAD, *BINNING, *TAIL],
    "local": [*HEAD, *BINNING, *TAIL],
}
CHILDREN = {"prep": "binning", "row_expand": "binning", "expand": "binning"}


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def spans_off():
    """Spans off and the ring empty before and after the test."""
    P.enable(False)
    P.reset()
    yield
    P.enable(False)
    P.reset()


def scene(n=400, seed=5, scale_range=(0.01, 0.06), device="cpu"):
    ds = generate_visible_gaussians(n, sh_degree=1, seed=seed,
                                    scale_range=scale_range)
    return ds.to_input(device=device)


def renderer(cls=T.DepthFirstRenderer, device="cpu", **config):
    return cls(T.RendererConfig(sh_degree=1, max_width=W, max_height=H,
                                **config), device=device)


def render(entry, gi, cam):
    """The frame function of ``entry`` (a key of TREES) on the device of
    ``gi``."""
    stereo = T.make_side_by_side_stereo(cam)
    dev = gi.device
    if entry in ("rows", "rows_off"):
        r = renderer(device=dev, row_expand=entry == "rows")
        return lambda: r.render(gi, cam, W, H)
    if entry in ("hardware", "global", "local"):
        cls = {"hardware": T.HardwareRenderer, "global": T.GlobalRenderer,
               "local": T.LocalRenderer}[entry]
        r = renderer(cls, device=dev)
        return lambda: r.render(gi, cam, W, H)
    r = renderer(device=dev)
    if entry == "stereo":
        return lambda: r.render_stereo(gi, stereo, W, H)
    target = T.make_rate_maps(W, H, **FOV)
    if entry == "foveated":
        return lambda: r.render_stereo_foveated(gi, stereo, target)
    return lambda: r.render_stereo_foveated_compress(gi, stereo, target)


def merged(names):
    return [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]


def test_off_by_default(monkeypatch, spans_off):
    """With no profiler and no enable(True) a frame records nothing and
    enters no record_function; enable(True) without a profiler records the
    frame and still enters none."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not P.active()
    assert P.span("project") is P.span("blend")  # the shared no-op context
    gi, cam = scene(), T.make_camera(W, H, far=20.0)
    frame = render("rows", gi, cam)
    before = P.counters()["frames"]
    frame()
    frame()
    assert P.frames() == []
    assert P.counters()["frames"] == before + 2
    P.enable(True)
    frame()
    assert [s["name"] for s in P.frames()[0]["spans"]] == TREES["rows"]


def _events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _inside(op, rng, eps=1e-3):
    return (rng["ts"] - eps <= op["ts"]
            and op["ts"] + op.get("dur", 0.0) <= rng["ts"] + rng["dur"] + eps)


@pytest.mark.parametrize("entry", list(TREES))
def test_frame_records_the_stage_tree(entry, spans_off):
    """Under the CPU profiler each frame records the stage tree in order;
    the ``gsm::`` ranges are user annotations; every ``aten::`` op of a
    frame lies inside a stage span (its innermost ``gsm::`` range is not
    ``gsm::frame``), and the sort's inside ``gsm::sort``."""
    from torch.profiler import ProfilerActivity, profile

    gi, cam = scene(), T.make_camera(W, H, far=20.0)
    frame = render(entry, gi, cam)
    frame()  # the full-model frame, then one at the locked capacity
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame()
        frame()
    recs = P.frames()
    assert len(recs) == 2
    for rec in recs:
        names = [s["name"] for s in rec["spans"]]
        assert merged(names) == TREES[entry], names
        for s in rec["spans"]:
            want = None if s["name"] == "frame" else CHILDREN.get(s["name"],
                                                                   "frame")
            assert s["parent"] == want, s
            assert s["host_ms"] == s["device_ms"] >= 0.0
        assert 0.0 < rec["entry_ms"] < rec["spans"][0]["host_ms"]
        assert rec["capacity"] > 0 and rec["slot_total"] > 0
        assert rec["overflow"] == 0

    events = _events(prof)
    gsm = sorted((e for e in events if e["name"].startswith("gsm::")),
                 key=lambda e: (e["ts"], -e["dur"]))
    assert {e["cat"] for e in gsm} == {"user_annotation"}
    frames = [e for e in gsm if e["name"] == "gsm::frame"]
    assert len(frames) == 2
    for fr, rec in zip(frames, recs):
        inner = [e for e in gsm if _inside(e, fr)]
        assert [e["name"][5:] for e in inner] == [s["name"] for s in rec["spans"]]
        stages = inner[1:]
        ops = [e for e in events if e.get("cat") == "cpu_op"
               and e["name"].startswith("aten::") and _inside(e, fr)]
        assert ops
        for op in ops:
            around = [s for s in stages if _inside(op, s)]
            assert around, f"{op['name']} outside every stage span"
            owner = max(around, key=lambda s: s["ts"])
            if op["name"] == "aten::sort":
                assert owner["name"] == "gsm::sort"


def test_lockin_refresh_and_short(monkeypatch, spans_off):
    """The first host read locks the capacity in; between refreshes the
    next pick reads the last frame's demand without a host read and grows
    the capacity past it (a regrow, short where that frame overflowed); a
    read ADAPTIVE_REFRESH frames after the lock-in refreshes it.  Only
    lock-ins and refreshes are host reads."""
    monkeypatch.setattr(base, "ADAPTIVE_REFRESH", 3)
    # as many gaussians, then larger ones: the capacity kind is the same
    small = scene(3000, scale_range=(0.005, 0.02))
    large = scene(3000, scale_range=(0.05, 0.2))
    cam = T.make_camera(W, W, far=20.0)
    r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1, max_width=W,
                                              max_height=W,
                                              row_expand=False), device="cpu")
    c0 = P.counters()
    r.render(small, cam, W, W)  # the full model: no read yet
    r.render(small, cam, W, W)  # reads the first frame's total: lock-in
    c1 = P.counters()
    assert c1["capacity_lockins"] - c0["capacity_lockins"] == 1
    assert c1["host_reads"] - c0["host_reads"] == 1
    (state,) = r.capacity_state()
    cap, demand = state["capacity"], state["demand"]
    assert state["kind"] == "df" and state["gaussians"] == 3000
    assert state["age"] == 0 and demand < cap
    out = r.render(large, cam, W, W)  # picked before the demand grew
    assert int(out.header.slot_total) > cap  # the demand grew past it
    assert int(out.header.overflow) == 1
    assert P.counters()["capacity_regrows"] == c1["capacity_regrows"]
    for k in range(2):  # the next pick grows the capacity, then keeps it
        out = r.render(large, cam, W, W)
        assert int(out.header.overflow) == 0
        (state,) = r.capacity_state()
        assert state["age"] == k + 2 and state["capacity"] > cap
        assert state["demand"] == int(out.header.slot_total)
    c2 = P.counters()
    assert c2["capacity_regrows"] - c1["capacity_regrows"] == 1
    assert c2["capacity_short"] - c1["capacity_short"] == 1
    assert c2["host_reads"] == c1["host_reads"]
    assert c2["capacity_refreshes"] == c1["capacity_refreshes"]
    grown = state["capacity"]
    r.render(large, cam, W, W)  # the refresh, at the demand it grew to
    c3 = P.counters()
    assert c3["capacity_refreshes"] - c2["capacity_refreshes"] == 1
    assert c3["capacity_short"] == c2["capacity_short"]
    assert c3["host_reads"] - c0["host_reads"] == (
        c3["capacity_lockins"] - c0["capacity_lockins"]
        + c3["capacity_refreshes"] - c0["capacity_refreshes"]) == 2
    (state,) = r.capacity_state()
    assert state["age"] == 0 and state["demand"] > cap
    assert state["capacity"] == grown > state["demand"]


def test_rows_count_their_own_reads(spans_off):
    """With rows on, the row and the instance capacities each lock in with
    a host read of their own."""
    gi, cam = scene(), T.make_camera(W, H, far=20.0)
    r = renderer()
    c0 = P.counters()
    for _ in range(3):
        r.render(gi, cam, W, H)
    c1 = P.counters()
    assert c1["capacity_lockins"] - c0["capacity_lockins"] == 2
    assert c1["host_reads"] - c0["host_reads"] == 2
    assert [s["kind"] for s in r.capacity_state()] == ["df", "df.rows"]


def test_overflow_frames(spans_off):
    """With ``max_instances`` too small for the scene every recorded frame
    overflows, and only recorded frames count."""
    gi, cam = scene(2000, scale_range=(0.05, 0.2)), T.make_camera(
        W, H, far=20.0)
    r = renderer(max_instances=4096)
    r.render(gi, cam, W, H)  # not recorded
    assert P.counters()["overflow_frames"] == 0
    P.enable(True)
    for _ in range(3):
        r.render(gi, cam, W, H)
    recs = P.frames()
    assert len(recs) == 3
    assert all(f["slot_total"] > f["capacity"] == 4096 for f in recs)
    assert P.counters()["overflow_frames"] == len(recs) == 3
    P.reset()
    assert P.counters()["overflow_frames"] == 0


def rebin_counts(entry, device, frames=3):
    """The re-bin counters' moves over ``frames`` frames of ``entry``."""
    frame = render(entry, scene(device=device), T.make_camera(W, H, far=20.0))
    c0 = P.counters()
    for _ in range(frames):
        frame()
    c1 = P.counters()
    return {k: c1[k] - c0[k] for k in ("rebin_kernel", "rebin_torch")}


@pytest.mark.parametrize("entry", ("rows", "stereo", "foveated", "compress"))
def test_rebin_counters_count_by_path(entry, spans_off):
    """On the CPU every foveated frame re-bins through the plain torch
    chain and counts ``rebin_torch``; no frame counts ``rebin_kernel``, and
    the frames that do not re-bin (mono, side by side, the compress path)
    count neither."""
    want = 3 if entry == "foveated" else 0
    assert rebin_counts(entry, "cpu") == dict(rebin_kernel=0,
                                              rebin_torch=want)


READERS = ("entry_host_ms", "span_project_ms", "span_binning_ms",
           "span_sort_ms", "span_blend_ms", "span_header_ms",
           "dead_slot_share")


@pytest.fixture(scope="module")
def traced_cell():
    """Frames of a tiny garden cell rendered under the CPU profiler: (the
    cell, the readers' context, the recorded frames)."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from gsmbench.harness import cell as cell_mod, scene as scene_mod, traffic
    from gsmbench.run import renderer_config

    P.enable(False)
    P.reset()
    cell = cell_mod.load("garden-mono-1080p.orbit")
    cfg = copy.deepcopy(cell.config)
    cfg["scene"]["count"] = 3000
    cfg["width"], cfg["height"] = 96, 64
    cfg["renderer_config"].update(max_width=96, max_height=64)
    gi = T.GaussianInput(**scene_mod.make_scene(cfg["scene"], 2 ** 31 + 7,
                                                "cpu"))
    r = T.DepthFirstRenderer(renderer_config(T, cfg), device="cpu")
    frame = cell.entry().build(T, cfg, r, gi)
    loop = traffic.poses(cell.traffic, cfg["viewpoint"], 7)
    for i in range(2):
        frame(loop[i])
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(2, 5):
            frame(loop[i])
    recs = P.frames()
    P.reset()
    return cell, dict(trace=dict(frames=3)), recs


@pytest.mark.parametrize("metric", READERS)
def test_span_readers(traced_cell, metric, monkeypatch):
    """Each reader of the renderer's spans and counters returns a positive
    float, what ``profiling.frames()`` says for the traced frames."""
    cell, ctx, recs = traced_cell
    assert len(recs) == 3
    monkeypatch.setattr(P, "frames", lambda: list(recs))
    got = cell.reader(metric)(ctx)
    stages = {"span_project_ms": ("project",), "span_binning_ms": ("binning",),
              "span_sort_ms": ("sort", "ranges"), "span_blend_ms": ("blend",),
              "span_header_ms": ("header",)}
    if metric == "entry_host_ms":
        want = np.mean([f["entry_ms"] for f in recs])
    elif metric == "dead_slot_share":
        want = np.mean([100.0 * (f["capacity"] - f["slot_total"])
                        / f["capacity"] for f in recs])
        assert 0.0 <= got < 100.0
    else:
        want = np.mean([sum(s["device_ms"] for s in f["spans"]
                            if s["name"] in stages[metric]) for f in recs])
    assert isinstance(got, float) and got > 0.0
    assert got == pytest.approx(float(want), rel=1e-12)
    monkeypatch.setattr(P, "frames", lambda: [])
    assert cell.reader(metric)(ctx) == 0.0
    monkeypatch.delattr(P, "frames")  # a renderer without spans
    assert cell.reader(metric)(ctx) is None


#: the hand kernels a frame of each entry launches, by the names a trace
#: shows: the sort's pack and ranges with the stages' own
SORT_KERNELS = {"sort_key_pack_kernel", "sort_ranges_kernel",
                "sort_ranges_counts_kernel"}
HAND_KERNELS = {
    "rows": {"project_kernel", "prep_kernel", "row_expand_kernel",
             "expand_kernel", "blend_kernel", *SORT_KERNELS},
    "foveated": {"stereo_project_kernel", "foveated_rebin_kernel",
                 "prep_kernel", "expand_kernel", "blend_kernel",
                 *SORT_KERNELS},
}
#: the C entries (``_native.Kernel``) a frame calls, one launch each: a
#: kernel above each, but the ranges' two kernels are one entry, and the
#: keys-only sort is an entry whose kernels are CUB's
ENTRIES = {"rows": 8, "foveated": 8}


@pytest.mark.card
@pytest.mark.parametrize("entry", ("stereo", "foveated"))
def test_rebin_counters_on_card(card, entry, spans_off):
    """On the card every foveated frame, eager or replayed, re-binned
    through the kernel: ``rebin_kernel`` counts each, ``rebin_torch``
    none."""
    want = 6 if entry == "foveated" else 0
    assert rebin_counts(entry, "cuda", 6) == dict(rebin_kernel=want,
                                                  rebin_torch=0)


@pytest.mark.card
@pytest.mark.parametrize("entry", list(HAND_KERNELS))
def test_kernel_launches_on_card(card, entry, spans_off):
    """On the card the launch counter grows by the hand kernels a frame
    launches, the kernels a traced frame shows.  The profiler can lose a
    kernel record of repeated calls (gsmbench/harness/trace.py), so the
    trace is held to the kernels' names, over three frames."""
    import re

    from torch.profiler import ProfilerActivity, profile

    frame = render(entry, scene(20000, device="cuda"),
                   T.make_camera(W, H, far=20.0))
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    before = P.counters()["kernel_launches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            frame()
        torch.cuda.synchronize()
    launched = P.counters()["kernel_launches"] - before
    seen = {m.group(1) for e in _events(prof) if e.get("cat") == "kernel"
            for m in [re.search(r"(\w+_kernel)\b", e["name"])] if m}
    assert launched == 3 * ENTRIES[entry]
    assert seen & {"project_kernel", "stereo_project_kernel", "prep_kernel",
                   "row_expand_kernel", "expand_kernel", "blend_kernel",
                   "general_blend_kernel", "bounds_gather_kernel",
                   "foveated_rebin_kernel", *SORT_KERNELS} \
        == HAND_KERNELS[entry], seen
