"""The port's side-by-side stereo frame (``DepthFirstRenderer.render_stereo``
on the CPU) against the benchmark's plain reference of it
(``gsmbench/reference/side_by_side.py``), on the ``garden-stereo-1080p``
configuration cut to a few thousand gaussians and 160x96 an eye, at poses
of the ``head-sway`` loop.  The splats are made larger than the
configuration's (whose scales are cut for 5.8M gaussians at 1080p), so that
most of them cover pixels here and some tiles saturate.  Imports no JAX."""

import copy

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsmbench.harness import cell as cell_mod, check, scene as scene_mod
from gsmbench.harness import traffic
from gsmbench.reference import foveation
from gsmbench.reference.render import Reference
from gsmbench.run import renderer_config

CELL = "garden-stereo-1080p.head-sway"
SEEDS = (5, 2 ** 33 + 17)
N, W, H = 4000, 160, 96
#: the scene's scale factor here: ~1800 of the 4000 gaussians visible,
#: ~5900 tile pairs, tiles that stop at the exit (the configuration's
#: 0.415 leaves ~120 visible)
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


@pytest.mark.parametrize("pose", (0, 67))
def test_port_matches_the_plain_reference(frames, pose):
    cell, ref, frame, loop = frames
    out = frame(loop[pose])
    want = cell.entry().reference(ref, cell.config, loop[pose])
    assert tuple(out.color.shape) == tuple(want.color.shape) == (H, 2 * W, 4)
    assert want.visible > 0 and want.counts["pairs"] > 0
    assert want.counts["eyes"] == 2 and want.counts["pixels"] == 2 * W * H
    assert float(want.slack.max()) > 0.0  # some tiles stop at the exit
    got = check.compare(out.color, out.depth, int(out.header.visible_count),
                        want)
    # float32 on both sides: a tile test or cull decided the other way by
    # float rounding moves a few pixels, so the mean stays far below a
    # float16 step
    assert got["color_mae"] < 1e-5, got
    # depth sums the records' float16 depths; the same few pixels
    assert got["depth_rel_mae"] < 1e-4, got
    # the visibility cull runs the same float32 chain on both sides
    assert got["visible_rel"] == 0.0, got
    assert check.judge(got, cell.workload["limits"]), got
    assert int(out.header.overflow) == 0


def test_both_eyes_see_the_scene(frames):
    """Each half of the side-by-side frame holds its own eye: both draw,
    and the eyes differ (the IPD moves the splats)."""
    cell, ref, frame, loop = frames
    out = frame(loop[0])
    left, right = out.color[:, :W], out.color[:, W:]
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


def test_rate_one_foveated_target_is_half_a_pixel_off():
    """Why the side-by-side frame has a reference path of its own: the
    foveated target at rate 1 samples pixel i at i + 0.5 and puts its tile
    boundaries at 16 k + 0.5, while the side-by-side frame samples pixel
    corners on tiles that start at 16 k."""
    t = foveation.target(1920, 1080, 1.0, 0.3, 16, 16)
    assert (t["render_width"], t["render_height"]) == (1920, 1080)
    assert (t["tiles_x"], t["tiles_y"]) == (120, 68)
    assert np.array_equal(t["px"][:1920], np.arange(1920) + 0.5)
    assert np.array_equal(t["bx"], np.arange(121) * 16 + 0.5)
    assert np.array_equal(t["by"], np.arange(69) * 16 + 0.5)
