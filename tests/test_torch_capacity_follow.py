"""The capacity contract follows the demand between refreshes
(``pipelines/base.py``): a scripted dolly towards the scene whose slot
demand grows by about 2% a frame, far faster than the 4% margin a 64-frame
refresh allows, renders with no overflow after the lock-in; the growth
reads the last frame's demand only once its copy's event is done, so that
no host read happens between refreshes; the counters count what they say;
``max_instances`` and ``adaptive_capacity=False`` still fix the capacity.
On the CPU the frames' blend is a stand-in (the contract reads the
headers only, and the plain blend would take most of a second a frame);
on the card (marked ``card``) the real frames between refreshes take no
host sync.  Imports no JAX."""

import types

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
from gsm_renderer_tpu_torch.pipelines import base, common
from gsm_renderer_tpu_torch.pipelines.base import instance_capacity

W, H, N = 128, 96, 6000
#: the dolly's step towards the scene, scene units a frame, and its frames
STEP, FRAMES = 0.04, 36
ENTRIES = ("rows", "rows_off", "stereo")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these frames are small, and a worker's threads
    beside other test workers' only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_blend(monkeypatch):
    """The frames' blend (in their tail, ``common.frame_output``) replaced
    by blank images of its shapes."""
    def blank(*args, tiles_x, tiles_y, width, height, n_eyes=1,
              depth_mode="weighted", **kwargs):
        dev = args[0].device
        color = torch.zeros((height, n_eyes * width, 4), device=dev)
        depth = (None if depth_mode == "none"
                 else torch.zeros((height, n_eyes * width), device=dev))
        return color, depth

    monkeypatch.setattr(common, "blend_image", blank)


def scene(device="cpu"):
    return generate_visible_gaussians(N, sh_degree=1, seed=5,
                                      scale_range=(0.03, 0.15)).to_input(
                                          device=device)


def camera(k: int):
    """Pose k of the dolly: the default camera moved k * STEP along +z."""
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -STEP * k
    return T.make_camera(W, H, position=(0.0, 0.0, STEP * k),
                         view_matrix=view, far=20.0)


def renderer(device="cpu", **config):
    return T.DepthFirstRenderer(
        T.RendererConfig(sh_degree=1, max_width=W, max_height=H, **config),
        device=device)


def frame_fn(entry, r, gi):
    if entry == "stereo":
        return lambda k: r.render_stereo(
            gi, T.make_side_by_side_stereo(camera(k)), W, H)
    return lambda k: r.render(gi, camera(k), W, H)


def dolly(entry, device="cpu"):
    """Render the dolly's frames; returns (renderer, each frame's
    (slot total, overflow), the capacity state after the lock-in, the
    counters' moves)."""
    r = renderer(device, row_expand=entry == "rows")
    frame = frame_fn(entry, r, scene(device))
    c0 = P.counters()
    got, locked = [], None
    for k in range(FRAMES):
        out = frame(k)
        got.append((int(out.header.slot_total), int(out.header.overflow)))
        if k == 1:
            locked = {s["kind"]: s["capacity"] for s in r.capacity_state()}
    c1 = P.counters()
    return r, got, locked, {k: c1[k] - c0[k] for k in c0
                            if isinstance(c0[k], int)}


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_overflow_after_the_lockin(no_blend, entry):
    """The demand grows past the capacity locked in at the second frame
    long before a refresh; the capacity grows with it, one frame behind,
    and no frame overflows."""
    r, got, locked, moved = dolly(entry)
    totals = [t for t, _ in got]
    kind = "df_stereo" if entry == "stereo" else "df"
    assert max(totals) > locked[kind]  # the old contract would overflow
    assert totals[-1] > 1.04 * totals[1]  # faster than 4% in 64 frames
    assert [o for _, o in got] == [0] * FRAMES
    caps = {s["kind"]: s for s in r.capacity_state()}
    assert caps[kind]["capacity"] > max(totals) > caps[kind]["demand"] * 0.9
    assert caps[kind]["age"] == FRAMES - 2
    lockins = 2 if entry == "rows" else 1
    assert moved["capacity_lockins"] == lockins
    assert moved["host_reads"] == lockins
    assert moved["capacity_refreshes"] == 0
    assert moved["capacity_short"] == 0
    assert moved["capacity_regrows"] >= 1


@pytest.mark.parametrize("entry", ENTRIES)
def test_refresh_shrinks_growth_does_not(no_blend, monkeypatch, entry):
    """Out and back: between refreshes the capacity only grows; each
    refresh re-reads the demand (a host read) and may shrink it."""
    monkeypatch.setattr(base, "ADAPTIVE_REFRESH", 5)
    r = renderer(row_expand=entry == "rows")
    frame = frame_fn(entry, r, scene())
    kind = "df_stereo" if entry == "stereo" else "df"
    c0 = P.counters()
    poses = list(range(16)) + list(range(15, -1, -1))
    caps = []
    for k in poses:
        frame(k)
        caps.append(next(s for s in r.capacity_state() if s["kind"] == kind)
                    if r.capacity_state() else None)
    c1 = P.counters()
    ages = [s["age"] for s in caps[1:]]
    assert ages[:7] == [0, 1, 2, 3, 4, 5, 0]
    for prev, cur in zip(caps[1:], caps[2:]):
        if cur["age"] > 0:  # between refreshes: never smaller
            assert cur["capacity"] >= prev["capacity"]
    assert any(cur["capacity"] < prev["capacity"]
               for prev, cur in zip(caps[1:], caps[2:]) if cur["age"] == 0)
    refreshes = sum(1 for s in caps[2:] if s["age"] == 0)
    lockins = 2 if entry == "rows" else 1
    moved = {k: c1[k] - c0[k] for k in ("capacity_lockins",
                                        "capacity_refreshes", "host_reads")}
    assert moved["capacity_lockins"] == lockins
    assert moved["capacity_refreshes"] == lockins * refreshes
    assert moved["host_reads"] == lockins * (1 + refreshes)


class _Event:
    """A stand-in for the copy's CUDA event: done or not, counting the
    waits."""

    def __init__(self):
        self.done, self.waits = False, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


@pytest.mark.parametrize("what", ("slots", "rows"))
def test_growth_waits_for_no_copy(monkeypatch, what):
    """Between refreshes a pick reads the copy only once its event is
    done and never waits for it; the lock-in and the refresh wait (host
    reads).  A growth whose demand exceeded the capacity counts as short."""
    monkeypatch.setattr(base, "ADAPTIVE_REFRESH", 4)
    n, kind = 5000, "k"
    r = renderer()
    ev = _Event()
    fb = types.SimpleNamespace(slot_total=None, row_total=None, event=ev)
    r._cap_feedback[(kind, n)] = fb

    def demand(v):
        setattr(fb, "row_total" if what == "rows" else "slot_total",
                torch.tensor(v, dtype=torch.int32))

    def pick():
        if what == "rows":
            return r.pick_row_capacity(n, kind=kind)
        return r.pick_capacity(n, kind=kind)

    c0 = P.counters()
    demand(6000)
    cap = pick()  # the lock-in waits for the copy
    assert ev.waits == 1 and 6000 < cap
    ev.done = False
    demand(3 * cap)  # a frame that overflowed, its copy not done yet
    assert pick() == cap and ev.waits == 1
    ev.done = True
    grown = pick()  # the copy is done: growth, no wait
    assert grown > 3 * cap and ev.waits == 1
    assert pick() == grown  # read again: nothing new
    c1 = P.counters()
    assert c1["host_reads"] - c0["host_reads"] == 1
    assert c1["capacity_regrows"] - c0["capacity_regrows"] == 1
    assert c1["capacity_short"] - c0["capacity_short"] == 1
    ev.done = False
    demand(6000)
    assert pick() == grown and ev.waits == 1  # age 4: still no wait
    assert pick() == cap  # the refresh: waits, and shrinks
    assert ev.waits == 2
    state = r._cap_state[("rows", kind, n) if what == "rows" else (kind, n)]
    assert state == {"cap": cap, "age": 0, "demand": 6000}
    c2 = P.counters()
    assert c2["host_reads"] - c0["host_reads"] == 2
    assert c2["capacity_refreshes"] - c1["capacity_refreshes"] == 1
    assert c2["capacity_regrows"] == c1["capacity_regrows"]


def test_fixed_capacities_do_not_follow(no_blend):
    """``max_instances`` fixes the instance capacity and
    ``adaptive_capacity=False`` every capacity at the full model, under the
    same growing demand."""
    gi = scene()
    fixed = renderer(row_expand=False, max_instances=1 << 16)
    off = T.DepthFirstRenderer(
        T.RendererConfig(sh_degree=1, max_width=W, max_height=H),
        device="cpu", adaptive_capacity=False)
    c0 = P.counters()
    P.enable(True)
    P.reset()
    try:
        for k in range(0, FRAMES, 3):
            fixed.render(gi, camera(k), W, H)
            off.render(gi, camera(k), W, H)
        recs = P.frames()
    finally:
        P.enable(False)
        P.reset()
    c1 = P.counters()
    assert {f["capacity"] for f in recs[0::2]} == {
        instance_capacity(fixed.config, N)}
    assert {f["capacity"] for f in recs[1::2]} == {
        instance_capacity(off.config, N)}
    assert off.pick_row_capacity(N) == -(-2 * N // 4096) * 4096
    assert not off._cap_state and not off._cap_feedback
    assert c1["capacity_regrows"] == c0["capacity_regrows"]
    assert all(f["counters"].get("capacity_regrows", 0) == 0 for f in recs)


def test_frame_records_its_regrows(no_blend):
    """A recorded frame keeps the counters that moved while it rendered:
    a growth counts in the frame whose pick grew."""
    r = renderer(row_expand=False)
    frame = frame_fn("rows_off", r, scene())
    P.enable(True)
    P.reset()
    try:
        for k in range(FRAMES):
            frame(k)
        recs = P.frames()
    finally:
        P.enable(False)
        P.reset()
    grew = [i for i, f in enumerate(recs)
            if f["counters"].get("capacity_regrows", 0)]
    assert grew and all(recs[i]["capacity"] > recs[i - 1]["capacity"]
                        for i in grew)
    assert recs[1]["counters"]["capacity_lockins"] == 1
    assert all(f["counters"].get("host_reads", 0) == 0 for f in recs[2:])


# -- on the card ---------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("entry", ENTRIES)
def test_card_follows_without_a_sync(card, entry):
    """On the card the growth reads the pinned copy: the frames after the
    lock-in make no synchronizing call (PyTorch's sync debug mode raises
    on one inside a frame), and none overflows."""
    r = renderer("cuda", row_expand=entry == "rows")
    frame = frame_fn(entry, r, scene("cuda"))
    flags = []
    for k in range(2):
        frame(k)
    torch.cuda.synchronize()
    c0 = P.counters()
    for k in range(2, FRAMES):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = frame(k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        flags.append(out.header.overflow)
        torch.cuda.synchronize()  # one frame in flight, as a viewer runs
    c1 = P.counters()
    assert [int(f) for f in flags] == [0] * (FRAMES - 2)
    assert c1["capacity_regrows"] - c0["capacity_regrows"] >= 2
    assert c1["host_reads"] == c0["host_reads"]
    fb = r._cap_feedback[("df_stereo" if entry == "stereo" else "df", N)]
    assert isinstance(fb, base._Demand) and fb.slot_total.is_pinned()
