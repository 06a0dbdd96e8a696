"""Captured frames (``pipelines/replay.py``) and the projections' pose
block (``kernels/project.py``).

On the CPU: the host-packed pose blocks hold ``csrc/project.cu``'s
ProjParams, and for two eyes both eyes' and StereoExtra, field by field,
their cached constants following what they are made of; a frame's graph
key changes with each value a capture bakes in (a foveated frame's target
among them) and not with the pose; CPU frames render
``depth_first_frame``'s frame and count no graph; a capture takes back the
counts it moved and each replay counts them again; the replay's header
copy; the benchmark's ``graph_replay_share`` reader.  On the card (marked
``card``): replayed mono (rows on and off), Hardware, side-by-side and
foveated stereo frames at new poses, across capacity growths and
refreshes, are bit-equal to eager frames and outlive the frames after them; a capacity
change re-captures; replays take no host sync; frames queued back to back
behind a sleep kernel each render their own camera; under spans each
replayed frame records its stage tree with its own device times; a
replayed frame's header comes from the kernels' records of its sums, and
its trace shows no PyTorch reduction and no more device operations than
the parent tree's less those sums.  This
file imports no JAX, so that ``python -m pytest --noconftest
tests/test_torch_graph_replay.py -m card`` runs it on a machine with a card
and without JAX."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import _native
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
from gsm_renderer_tpu_torch.kernels import blend as KB
from gsm_renderer_tpu_torch.kernels import project as KP
from gsm_renderer_tpu_torch.pipelines import base, depth_first, replay
from gsm_renderer_tpu_torch.pipelines.replay import copy_header
from gsmbench.harness.timing import sleep_cycles_per_ms
from gsmbench.harness.trace import trace_frames

CSRC = Path(KP.__file__).resolve().parent.parent / "csrc" / "project.cu"
W, H, N = 128, 96, 6000
#: the dolly's step towards the scene, scene units a frame (its slot demand
#: grows by about 2% a frame: capacity growths between refreshes)
STEP = 0.04
ENTRIES = ("rows", "rows_off", "hardware", "stereo", "foveated")
#: the foveated frames' rate maps
FOV = dict(min_rate=0.4, radius=0.3)
CONSTS = dict(width=W, height=H, near_plane=0.1, far_plane=20.0,
              alpha_threshold=0.005, total_ink_threshold=2.0)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def spans_off():
    """Spans off and the ring empty before and after each test."""
    P.enable(False)
    P.reset()
    yield
    P.enable(False)
    P.reset()


#: the CPU tests' smaller frames (the plain blend is slow)
CPU_W, CPU_H, CPU_N = 48, 32, 1500


def scene(device="cpu", seed=5, n=N):
    return generate_visible_gaussians(n, sh_degree=1, seed=seed,
                                      scale_range=(0.03, 0.15)).to_input(
                                          device=device)


def camera(k, width=W, height=H, far=20.0):
    """Pose k of the dolly: the default camera moved k * STEP along +z."""
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -STEP * k
    return T.make_camera(width, height, position=(0.0, 0.0, STEP * k),
                         view_matrix=view, far=far)


def renderer(entry, device="cpu", eager=False, **config):
    cls = T.HardwareRenderer if entry == "hardware" else T.DepthFirstRenderer
    config.setdefault("row_expand", entry == "rows")
    r = cls(T.RendererConfig(sh_degree=1, max_width=2 * W, max_height=2 * H,
                             **config), device=device)
    r._eager_frames = eager
    return r


_TARGETS: dict = {}


def target(width, height, **fov):
    """The foveated target of a display size, one object a size and rate
    map (its device tables are cached on it)."""
    fov = dict(FOV, **fov)
    key = (width, height, *sorted(fov.items()))
    return _TARGETS.setdefault(key, T.make_rate_maps(width, height, **fov))


def frame_fn(entry, r, gi, width=W, height=H):
    if entry == "foveated":
        tgt = target(width, height)
        return lambda k: r.render_stereo_foveated(
            gi, T.make_side_by_side_stereo(camera(k, width, height)), tgt)
    if entry == "stereo":
        return lambda k: r.render_stereo(
            gi, T.make_side_by_side_stereo(camera(k, width, height)), width,
            height)
    return lambda k: r.render(gi, camera(k, width, height), width, height)


def moved(c0, c1):
    return {k: c1[k] - c0[k] for k in c0 if isinstance(c0[k], int)}


# -- the pose block --------------------------------------------------------------


def struct_fields(name, source=None):
    """[(field, float count)] of ``struct name`` in csrc/project.cu, nested
    structs expanded as (field.sub, count)."""
    source = source or CSRC.read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for stmt in filter(None, (t.strip() for t in body.split(";"))):
        typ, names = stmt.split(None, 1)
        for field in (f.strip() for f in names.split(",")):
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", field)
            count = int(m.group(2) or 1)
            if typ in ("float", "uint32_t", "int"):
                out.append((m.group(1), count))
            else:
                out += [(f"{m.group(1)}.{sub}", c)
                        for sub, c in struct_fields(typ, source)]
    return out


def unpack(block, fields):
    """{field: its float32 values} of a host block laid out as ``fields``."""
    out, at = {}, 0
    for name, count in fields:
        out[name] = block[at:at + count]
        at += count
    assert at == block.size, (at, block.size)
    return out


def eye_fields(view, proj, center, consts):
    """The expected fields of one eye's ProjParams."""
    k = KP.frame_constants(proj, **consts)
    want = dict(view=np.asarray(view, np.float32).ravel(),
                proj=np.asarray(proj, np.float32).ravel(),
                center=np.asarray(center, np.float32))
    want.update({name: np.float32(v) for name, v in k.items()})
    return want


def check_fields(got, want, prefix=""):
    assert {f.removeprefix(prefix) for f in got if f.startswith(prefix)} \
        == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[prefix + name],
                                      np.atleast_1d(value), err_msg=name)


def test_pose_block_matches_the_struct():
    """pose_block packs ProjParams field by field: the matrices row-major,
    the centre, each frame constant under its own name."""
    cam = camera(3)
    host = KP.pose_block(cam.view_matrix, cam.projection_matrix,
                         cam.position, **CONSTS)
    assert host.dtype == np.float32
    check_fields(unpack(host, struct_fields("ProjParams")),
                 eye_fields(cam.view_matrix, cam.projection_matrix,
                            cam.position, CONSTS))


def test_stereo_pose_block_matches_the_struct():
    """stereo_pose_block packs the dual-eye kernel's pose arguments: each
    eye's ProjParams, left first, then StereoExtra (scene transform, scene
    scale, mid centre)."""
    st = np.eye(4, dtype=np.float32)
    st[:3, :3] *= 1.5
    st[:3, 3] = (0.1, -0.2, 0.3)
    rig = T.make_side_by_side_stereo(camera(2))
    views, projs, centers, _ = depth_first._stereo_rig(rig)
    host = KP.stereo_pose_block(views, projs, centers, st, **CONSTS)
    got = unpack(host, [(f"{eye}.{name}", c) for eye in ("left", "right")
                        for name, c in struct_fields("ProjParams")]
                 + [(f"extra.{name}", c)
                    for name, c in struct_fields("StereoExtra")])
    for e, eye in enumerate(("left.", "right.")):
        check_fields(got, eye_fields(views[e], projs[e], centers[e], CONSTS),
                     prefix=eye)
    scale, mid = KP.stereo_constants(centers, st)
    check_fields(got, dict(st=st.ravel(), scene_scale=scale, mid=mid),
                 prefix="extra.")


def test_pose_block_follows_the_projection():
    """The cached frame constants follow every value they are made of: a
    new projection, size, near or far, or threshold gives the block of a
    fresh frame_constants."""
    cam = camera(1)
    base_block = KP.pose_block(cam.view_matrix, cam.projection_matrix,
                               cam.position, **CONSTS)
    proj = cam.projection_matrix.copy()
    proj[0, 0] *= 1.25
    for p, change in ((proj, {}), (cam.projection_matrix, dict(width=W + 1)),
                      (cam.projection_matrix, dict(near_plane=0.2)),
                      (cam.projection_matrix, dict(far_plane=30.0)),
                      (cam.projection_matrix, dict(alpha_threshold=0.01)),
                      (cam.projection_matrix, dict(total_ink_threshold=1.0))):
        consts = dict(CONSTS, **change)
        got = KP.pose_block(cam.view_matrix, p, cam.position, **consts)
        assert not np.array_equal(got, base_block)
        check_fields(unpack(got, struct_fields("ProjParams")),
                     eye_fields(cam.view_matrix, p, cam.position, consts))


# -- the graph key, eager frames and the counters on the CPU ---------------------


@pytest.fixture
def keys(monkeypatch):
    """The graph key replay.py builds for each frame (``frame_key``) and
    whether the frame may be captured, in order."""
    got = []
    render = replay.FrameGraphs.render

    def record(self, kind, frame, kw, prepared, **graph):
        got.append((replay.frame_key(kind, kw, prepared),
                    graph["graphable"]()))
        return render(self, kind, frame, kw, prepared, **graph)

    monkeypatch.setattr(replay.FrameGraphs, "render", record)
    return got


@pytest.mark.parametrize("entry", ENTRIES)
def test_graph_key_changes_with_baked_values(keys, monkeypatch, entry):
    """The key stays under a new pose and changes with the capacity, the
    size, near and far, the scene and the blend's early exit (and a
    foveated frame's target); rows on and off key apart."""
    gi = scene(n=CPU_N)
    r = renderer(entry)
    frame = frame_fn(entry, r, gi, CPU_W, CPU_H)
    frame(1)  # the full model
    frame(1)  # the locked capacity
    frame(0)  # new poses, within the capacity's margin
    frame(0.5)
    (k1, _), (k2, _), (k3, _) = keys[1:4]
    assert k2 == k1 and k3 == k1
    stereo = entry == "stereo"

    def again(r2=r, gi2=gi, cam=camera(0.5, CPU_W, CPU_H), width=CPU_W,
              height=CPU_H, tgt=None):
        if entry == "foveated":
            r2.render_stereo_foveated(gi2, T.make_side_by_side_stereo(cam),
                                      tgt or target(width, height))
        elif stereo:
            r2.render_stereo(gi2, T.make_side_by_side_stereo(cam), width,
                             height)
        else:
            r2.render(gi2, cam, width, height)
        return keys[-1][0]

    assert again() == k1
    assert again(gi2=scene(seed=6, n=CPU_N)) != k1
    assert again(width=CPU_W + 16,
                 cam=camera(0.5, width=CPU_W + 16, height=CPU_H)) != k1
    assert again(cam=camera(0.5, CPU_W, CPU_H, far=30.0)) != k1
    fixed = renderer(entry, max_instances=1 << 16)
    assert again(r2=fixed) != k1 and again(r2=fixed) != k1
    if entry == "foveated":  # a new target: new tables, new rate map
        assert again(tgt=T.make_rate_maps(CPU_W, CPU_H, **FOV)) != k1
        assert again(tgt=target(CPU_W, CPU_H, min_rate=0.15)) != k1
        assert again() == k1
    monkeypatch.setattr(KB, "MIN_TRANSMITTANCE", 0.0)  # the exit off
    assert again() != k1
    if entry in ("rows", "rows_off"):
        other = renderer(entry, row_expand=entry != "rows")
        for _ in range(3):  # the full model, then its own locked capacity
            assert again(r2=other) != k1
    assert all(g for _, g in keys)


def test_eager_cpu_frames_are_depth_first_frames():
    """A CPU frame of the renderer is depth_first_frame's frame at the
    capacities it picked, bit for bit, and moves no graph counter."""
    gi, cam = scene(n=CPU_N), camera(3, CPU_W, CPU_H)
    r = renderer("rows")
    c0 = P.counters()
    for _ in range(3):
        out = r.render(gi, cam, CPU_W, CPU_H)
    c1 = P.counters()
    caps = {s["kind"]: s["capacity"] for s in r.capacity_state()}
    c = r.config
    want = depth_first.depth_first_frame(
        gi, cam.view_matrix, cam.projection_matrix, cam.position,
        width=CPU_W, height=CPU_H, capacity=caps["df"],
        row_capacity=caps["df.rows"],
        sh_degree=1, alpha_threshold=c.alpha_threshold,
        total_ink_threshold=c.total_ink_threshold,
        near_plane=cam.near_plane, far_plane=cam.far_plane,
        input_is_srgb=False)
    assert torch.equal(out.color, want.color)
    assert torch.equal(out.depth, want.depth)
    for f in ("visible_count", "total_instances", "overflow", "slot_total",
              "row_total"):
        assert torch.equal(getattr(out.header, f), getattr(want.header, f))
    assert {"graph_captures", "graph_replays"} <= set(c1)
    assert c1["graph_captures"] == c0["graph_captures"]
    assert c1["graph_replays"] == c0["graph_replays"]
    assert not r._graphs._graphs


def test_capture_takes_back_its_counts():
    """A capture keeps the counters and launches it moved for its replays
    and counts one capture; each replay counts them again."""
    kernel = _native.KERNELS[0]
    c0 = P.counters()
    with P.capturing() as rec:
        P.count("sort_keys_only")
        kernel.launches += 2
    c1 = P.counters()
    assert moved(c0, c1) == {**dict.fromkeys(moved(c0, c1), 0),
                             "graph_captures": 1}
    assert rec.counts == {"sort_keys_only": 1}
    assert rec.launches == [(kernel, 2)] and rec.spans == []
    header = T.FrameHeader(*(torch.tensor(0, dtype=torch.int32)
                             for _ in range(3)))
    for _ in range(2):
        assert P.replayed(rec, 0, header) == []
    got = moved(c1, P.counters())
    assert got["graph_replays"] == 2 and got["sort_keys_only"] == 2
    assert got["kernel_launches"] == 4 and got["graph_captures"] == 0


def test_copy_header_is_new_tensors():
    """A replay's header: new 0-d int32 tensors holding the graph's
    counters, None where the graph's is."""
    h = T.FrameHeader(*(torch.tensor(v, dtype=torch.int32)
                        for v in (7, 9, 0, 11)))
    got = copy_header(h)
    assert got.row_total is None
    for f in ("visible_count", "total_instances", "overflow", "slot_total"):
        v, old = getattr(got, f), getattr(h, f)
        assert v.shape == () and v.dtype == torch.int32
        assert int(v) == int(old) and v.data_ptr() != old.data_ptr()


def test_graph_replay_share_reader(monkeypatch):
    """graph_replay_share: 100 x replays over the traced frames; 0 for CPU
    frames; None for a renderer that counts no replays or records no
    frames."""
    from gsmbench.harness import cell as cell_mod

    read = cell_mod.load("garden-mono-1080p.orbit").reader(
        "graph_replay_share")
    ctx = dict(trace=dict(frames=2))
    gi, cam = scene(n=CPU_N), camera(1, CPU_W, CPU_H)
    r = renderer("rows_off")
    r.render(gi, cam, CPU_W, CPU_H)
    P.enable(True)
    r.render(gi, cam, CPU_W, CPU_H)
    r.render(gi, cam, CPU_W, CPU_H)
    assert read(ctx) == 0.0
    recs = [dict(counters={"graph_replays": 1}), dict(counters={})]
    monkeypatch.setattr(P, "frames", lambda: recs)
    assert read(ctx) == 50.0
    counters = P.counters
    monkeypatch.setattr(P, "counters", lambda: {
        k: v for k, v in counters().items() if not k.startswith("graph_")})
    assert read(ctx) is None
    monkeypatch.setattr(P, "counters", counters)
    monkeypatch.delattr(P, "frames")
    assert read(ctx) is None


# -- on the card -----------------------------------------------------------------


def same_output(a, b):
    assert torch.equal(a.color, b.color)
    assert (a.depth is None) == (b.depth is None)
    if a.depth is not None:
        assert torch.equal(a.depth, b.depth)
    for f in ("visible_count", "total_instances", "overflow", "slot_total",
              "row_total"):
        x, y = getattr(a.header, f), getattr(b.header, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert int(x) == int(y), f


@pytest.mark.card
@pytest.mark.parametrize("entry", ENTRIES)
def test_card_replays_are_eager_frames(card, monkeypatch, entry):
    """The dolly's frames at twice its step, one in flight, with a refresh
    every 10 frames: the replayed frames equal the eager frames bit for bit
    (image, depth, header) after every later frame has rendered; a capture
    happens exactly where the capacities change."""
    monkeypatch.setattr(base, "ADAPTIVE_REFRESH", 10)
    gi = scene("cuda")
    g, e = renderer(entry, "cuda"), renderer(entry, "cuda", eager=True)
    fg, fe = frame_fn(entry, g, gi), frame_fn(entry, e, gi)
    frames = 28
    outs, caps, captured = [], [], []
    c0 = P.counters()
    for k in range(frames):
        before = P.counters()["graph_captures"]
        outs.append(fg(2 * k))
        torch.cuda.synchronize()  # one frame in flight, as a viewer runs
        captured.append(P.counters()["graph_captures"] - before)
        caps.append([(s["kind"], s["capacity"]) for s in g.capacity_state()])
    got = moved(c0, P.counters())
    assert got["graph_replays"] == frames - 1  # the first frame is eager
    assert got["capacity_regrows"] >= 1 and got["capacity_refreshes"] >= 2
    changed = [k == 1 or caps[k] != caps[k - 1] for k in range(1, frames)]
    assert captured == [0] + [int(c) for c in changed]
    assert sum(changed) < frames - 1
    c1 = P.counters()
    for k in range(frames):
        want = fe(2 * k)
        torch.cuda.synchronize()
        assert [(s["kind"], s["capacity"]) for s in e.capacity_state()] \
            == caps[k]
        same_output(outs[k], want)
    got = moved(c1, P.counters())
    assert got["graph_captures"] == got["graph_replays"] == 0


@pytest.mark.card
@pytest.mark.parametrize("entry", ENTRIES)
def test_card_replays_take_no_sync(card, entry):
    """Between refreshes the replayed frames, re-captures at growths
    included, make no synchronizing call (PyTorch's sync debug mode raises
    on one)."""
    r = renderer(entry, "cuda")
    frame = frame_fn(entry, r, scene("cuda"))
    for k in range(2):
        frame(k)
    torch.cuda.synchronize()
    c0 = P.counters()
    for k in range(2, 36):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = frame(k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(out.header.overflow) == 0
    got = moved(c0, P.counters())
    assert got["graph_replays"] == 34 and got["host_reads"] == 0
    assert 1 <= got["graph_captures"] <= got["capacity_regrows"]


@pytest.mark.card
@pytest.mark.parametrize("entry", ENTRIES)
def test_card_queued_frames_read_their_own_pose(card, entry):
    """Five frames queued back to back behind a sleep kernel, each at its
    own camera, render the five eager frames: each pose written into the
    graph before its launch leaves the launches queued before it as they
    were."""
    gi = scene("cuda")
    g, e = renderer(entry, "cuda"), renderer(entry, "cuda", eager=True)
    fg, fe = frame_fn(entry, g, gi), frame_fn(entry, e, gi)
    poses = range(10, 15)
    for _ in range(2):  # both renderers' capacities settle alike
        for k in poses:
            fg(k)
            fe(k)
            torch.cuda.synchronize()
    want = []
    for k in poses:
        want.append(fe(k))
        torch.cuda.synchronize()
    c0 = P.counters()
    torch.cuda._sleep(int(sleep_cycles_per_ms() * 200))
    mark = torch.cuda.Event()
    mark.record()
    outs = [fg(k) for k in poses]
    ahead = not mark.query()
    torch.cuda.synchronize()
    assert ahead, "the sleep ended before the frames were queued"
    got = moved(c0, P.counters())
    assert got["graph_replays"] == 5 and got["graph_captures"] == 0
    for a, b in zip(outs, want):
        same_output(a, b)


@pytest.mark.card
@pytest.mark.parametrize("entry", ("rows", "stereo", "foveated"))
def test_card_replays_record_their_spans(card, entry):
    """Under spans each replayed frame records the stage tree under its
    replay span, with device times of its own, and counts its replay and
    the launches of its capture."""
    r = renderer(entry, "cuda")
    frame = frame_fn(entry, r, scene("cuda"))
    eager = renderer(entry, "cuda", eager=True)
    fe = frame_fn(entry, eager, scene("cuda"))
    for k in range(3):
        frame(k)
        fe(k)
    torch.cuda.synchronize()
    launches = P.counters()["kernel_launches"]
    fe(3)
    per_frame = P.counters()["kernel_launches"] - launches
    P.enable(True)
    P.reset()
    launches = P.counters()["kernel_launches"]
    for k in range(3, 9):
        frame(k)
    recs = P.frames()
    assert P.counters()["kernel_launches"] - launches == 6 * per_frame
    stages = ["project", *(["rebin"] if entry == "foveated" else []),
              "binning", "prep", *(["row_expand"] if entry == "rows"
                                   else []),
              "expand", "sort", "ranges", "blend", "header"]
    for rec in recs:
        names = [s["name"] for s in rec["spans"]]
        assert names == ["frame", "entry", "capacity", "replay", *stages,
                         "capacity", "output"], names
        spans = {s["name"]: s for s in rec["spans"]}
        assert spans["project"]["parent"] == "replay"
        assert spans["prep"]["parent"] == "binning"
        # the header launches nothing on the card: its span may read 0
        assert all(spans[s]["device_ms"] > 0.0 for s in stages
                   if s != "header")
        assert spans["header"]["device_ms"] >= 0.0
        assert sum(spans[s]["device_ms"] for s in stages
                   if s not in ("prep", "row_expand", "expand")) \
            <= spans["replay"]["device_ms"] + 0.01
        assert rec["counters"]["graph_replays"] == 1
        assert rec["counters"]["sort_keys_only"] == 1
        assert rec["counters"].get("rebin_kernel", 0) == (entry == "foveated")
        assert rec["capacity"] > 0 and rec["overflow"] == 0
    assert sum(rec["counters"].get("graph_captures", 0) for rec in recs) >= 1
    assert len({rec["spans"][4]["device_ms"] for rec in recs}) > 1


#: the device operations a replayed frame of the dolly's scene at pose 5
#: launched before the prep and ranges kernels wrote the header's sums, as
#: a trace counts them (the graph's and the header copy's; H100 80GB HBM3),
#: and how many of them were the header's PyTorch ops (reductions, int64
#: casts and bit ops over the gaussians); a stray fill lands in some traced
#: frames only, so the bound is rounded up to whole launches
PARENT_LAUNCHES = {"rows": (55.5, 21), "rows_off": (53.5, 21),
                   "stereo": (43.5, 12)}


@pytest.mark.card
@pytest.mark.parametrize("entry", list(PARENT_LAUNCHES))
def test_card_replayed_headers_take_no_torch_sums(card, entry):
    """A replayed frame's header comes from the kernels' records: it
    equals the eager frame's, every replay counts ``header_sums_kernel``
    and none ``header_sums_torch``, and the trace of four replays at one
    pose shows no PyTorch reduction and no more device operations a frame
    than PARENT_LAUNCHES' count less the header's ops."""
    gi = scene("cuda")
    g, e = renderer(entry, "cuda"), renderer(entry, "cuda", eager=True)
    fg, fe = frame_fn(entry, g, gi), frame_fn(entry, e, gi)
    for _ in range(3):  # eager, then the capture and a replay
        fg(5)
        fe(5)
    torch.cuda.synchronize()
    # spans record under the profiler, which the graph key holds: the
    # first traced frame captures again
    trace_frames(lambda k: (fg(5), torch.cuda.synchronize()), 1)
    c0 = P.counters()
    trace = trace_frames(lambda k: (fg(5), torch.cuda.synchronize()), 4)
    got = moved(c0, P.counters())
    assert got["graph_replays"] == 4 and got["graph_captures"] == 0
    assert got["header_sums_kernel"] == 4 and got["header_sums_torch"] == 0
    assert not [k for k in trace["kernels"] if "reduce_kernel" in k]
    parent, header_ops = PARENT_LAUNCHES[entry]
    assert trace["launches"] / 4 <= math.ceil(parent - header_ops)
    out = fg(5)
    same_output(out, fe(5))
    assert int(out.header.overflow) == 0
