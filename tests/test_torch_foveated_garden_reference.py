"""The port's foveated stereo frame (``DepthFirstRenderer.
render_stereo_foveated`` on the CPU) against the benchmark's plain reference
of it (``gsmbench/reference/render.py``'s ``Reference.stereo`` into
``gsmbench/reference/foveation.py``'s target, worked out again from the
rate-map parameters), on the ``garden-foveated-1080p`` configuration cut to
a few thousand gaussians and 160x96 an eye at the cell's rate map (min_rate
0.15, radius 0.3), at poses of the ``head-sway`` loop, under the cell's
limits.  The splats are made larger than the configuration's (whose scales
are cut for 5.8M gaussians at 1080p), so that most of them cover pixels
here and some tiles saturate.  Imports no JAX."""

import copy

import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import profiling as P
from gsmbench.harness import cell as cell_mod, check, scene as scene_mod
from gsmbench.harness import traffic
from gsmbench.reference import foveation
from gsmbench.reference.render import Reference
from gsmbench.run import renderer_config

CELL = "garden-foveated-1080p.head-sway"
SEEDS = (5, 2 ** 33 + 17)
N, W, H = 4000, 160, 96
#: the scene's scale factor here, as in test_torch_stereo_sbs_reference.py:
#: most of the 4000 gaussians visible and tiles that stop at the exit (the
#: configuration's 0.415 leaves ~120 visible)
SCALE = 6.0


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the frames are small, and a worker's threads
    beside other test workers' only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cell():
    cell = cell_mod.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["scene"].update(count=N, scale_factor=SCALE)
    cfg["width"], cfg["height"] = W, H
    cfg["renderer_config"].update(max_width=W, max_height=H)
    cell.config = cfg
    return cell


@pytest.fixture(scope="module", params=SEEDS)
def frames(request):
    """(cell, the reference, the port's frame function, the pose loop) of
    one seed."""
    seed = request.param
    cell = _cell()
    cfg = cell.config
    scene = scene_mod.make_scene(cfg["scene"], seed, "cpu")
    renderer = T.DepthFirstRenderer(renderer_config(T, cfg), device="cpu")
    frame = cell.entry().build(T, cfg, renderer, T.GaussianInput(**scene))
    loop = traffic.poses(cell.traffic, cfg["viewpoint"], seed)
    ref = Reference(scene, sh_degree=cfg["scene"]["sh_degree"],
                    tile=cfg["tile"])
    return cell, ref, frame, loop


def test_the_cell_runs_the_r15_map():
    """The configuration is the garden stereo one through the foveated
    entry at bench.py's aggressive map: at the cell's own size a 1703x958
    physical target an eye, 107x60 physical tiles."""
    cell = cell_mod.load(CELL)
    cfg, stereo = cell.config, cell_mod.load("garden-stereo-1080p.head-sway")
    assert cfg["entry"] == "render_stereo_foveated" and cfg["reduced"] == []
    assert cfg["foveation"] == dict(min_rate=0.15, radius=0.3)
    for key in ("scene", "camera", "viewpoint", "ipd", "renderer",
                "renderer_config", "precision", "tile", "width", "height"):
        assert cfg[key] == stereo.config[key], key
    t = foveation.target(cfg["width"], cfg["height"], 0.15, 0.3, 16, 16)
    assert (t["render_width"], t["render_height"]) == (1703, 958)
    assert (t["tiles_x"], t["tiles_y"]) == (107, 60)


@pytest.mark.parametrize("pose", (0, 67))
def test_port_matches_the_plain_reference(frames, pose):
    cell, ref, frame, loop = frames
    c0 = P.counters()
    out = frame(loop[pose])
    assert P.counters()["rebin_torch"] - c0["rebin_torch"] == 1
    want = cell.entry().reference(ref, cell.config, loop[pose])
    fov = cell.config["foveation"]
    t = foveation.target(W, H, fov["min_rate"], fov["radius"], 16, 16)
    shape = (t["render_height"], 2 * t["render_width"], 4)
    assert tuple(out.color.shape) == tuple(want.color.shape) == shape
    assert t["render_width"] < 0.9 * W and t["render_height"] < 0.9 * H
    assert want.visible > 0 and want.counts["pairs"] > 0
    assert want.counts["eyes"] == 2
    assert float(want.slack.max()) > 0.0  # some tiles stop at the exit
    got = check.compare(out.color, out.depth, int(out.header.visible_count),
                        want)
    # float32 on both sides: a tile test or cull decided the other way by
    # float rounding moves a few pixels
    assert got["color_mae"] < 1e-5, got
    assert got["depth_rel_mae"] < 1e-4, got
    # the visibility cull runs the same float32 chain on both sides
    assert got["visible_rel"] == 0.0, got
    assert check.judge(got, cell.workload["limits"]), got
    assert int(out.header.overflow) == 0


def test_both_eyes_see_the_scene(frames):
    """Each half of the physical frame holds its own eye: both draw, and
    the eyes differ (the IPD moves the splats)."""
    cell, ref, frame, loop = frames
    out = frame(loop[0])
    half = out.color.shape[1] // 2
    left, right = out.color[:, :half], out.color[:, half:]
    assert float(left[..., 3].max()) > 0.0 and float(right[..., 3].max()) > 0.0
    assert not torch.equal(left, right)


def test_control_fails_the_limits(frames):
    """The reference in bfloat16, in the renderer's place, is not correct
    by the cell's limits."""
    cell, ref, frame, loop = frames
    low = Reference(ref.scene, sh_degree=ref.sh_degree, tile=ref.tile,
                    dtype=torch.bfloat16)
    want = cell.entry().reference(ref, cell.config, loop[7])
    got = cell.entry().reference(low, cell.config, loop[7])
    numbers = check.compare(got.color, got.depth, got.visible, want)
    assert not check.judge(numbers, cell.workload["limits"]), numbers
