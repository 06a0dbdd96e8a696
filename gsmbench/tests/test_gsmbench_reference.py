"""The plain reference against the renderer's CPU path, and the control.

The reference (gsmbench/reference) imports nothing of the renderer; this
test may.  Small scenes of the cells' statistics and both entry points, on the
CPU."""

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsmbench.harness import check, scene as scene_mod, traffic
from gsmbench.reference import foveation
from gsmbench.reference.render import Reference
from gsmbench.tests.conftest import TINY, tiny

SEEDS = (5, 2 ** 33 + 17)


def _frames(name, n, w, h, seed):
    """(cell, scene, renderer input, frame function, loop of poses)."""
    cell = tiny(name, n, w, h)
    cfg = cell.config
    scene = scene_mod.make_scene(cfg["scene"], seed, "cpu")
    gi = T.GaussianInput(**scene)
    from gsmbench.run import renderer_config

    renderer = T.DepthFirstRenderer(renderer_config(T, cfg), device="cpu")
    frame = cell.entry().build(T, cfg, renderer, gi)
    loop = traffic.poses(cell.traffic, cfg["viewpoint"], seed)
    return cell, scene, frame, loop


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,n,w,h", TINY)
def test_reference_matches_cpu_path(name, n, w, h, seed):
    cell, scene, frame, loop = _frames(name, n, w, h, seed)
    ref = Reference(scene, sh_degree=3, tile=cell.config["tile"])
    for i in (0, len(loop) // 3):
        out = frame(loop[i])
        want = cell.entry().reference(ref, cell.config, loop[i])
        got = check.compare(out.color, out.depth,
                            int(out.header.visible_count), want)
        assert want.visible > 0 and want.counts["pairs"] > 0
        # float32 on both sides; a boundary flip moves a few pixels
        assert got["color_mae"] < 1e-5, got
        assert got["depth_rel_mae"] < 1e-4, got
        assert got["visible_rel"] == 0.0, got
        assert check.judge(got, cell.workload["limits"]), got


def test_foveated_target_matches_renderer():
    t = foveation.target(1920, 1080, 0.4, 0.3, 16, 16)
    ported = T.make_rate_maps(1920, 1080, min_rate=0.4, radius=0.3)
    tabs = T.foveated_raster_tables(ported, 16, 16)
    assert (t["render_width"], t["render_height"]) == (
        ported.render_width, ported.render_height) == (1767, 994)
    assert np.array_equal(t["bx"], tabs["bounds"][0][:t["tiles_x"] + 1])
    assert np.array_equal(t["by"], tabs["bounds"][1][:t["tiles_y"] + 1])
    assert np.array_equal(t["px"][:16], tabs["coord_x"][0][:16])


@pytest.mark.parametrize("name,n,w,h", TINY)
def test_control_fails_the_check(name, n, w, h):
    """The reference in bfloat16, in the renderer's place, is not correct
    by the cell's limits."""
    cell = tiny(name, n, w, h)
    cfg = cell.config
    for seed in SEEDS:
        scene = scene_mod.make_scene(cfg["scene"], seed, "cpu")
        loop = traffic.poses(cell.traffic, cfg["viewpoint"], seed)
        exact = Reference(scene, sh_degree=3)
        low = Reference(scene, sh_degree=3, dtype=torch.bfloat16)
        want = cell.entry().reference(exact, cfg, loop[7])
        got = cell.entry().reference(low, cfg, loop[7])
        numbers = check.compare(got.color, got.depth, got.visible, want)
        assert not check.judge(numbers, cell.workload["limits"]), numbers


def test_exit_slack_bounds_another_alignment(monkeypatch):
    """Where the 256-rank batches fall (the 128-rank blocks of the frame's
    tile-major order) moves where a saturated tile stops; the frame's
    slack bounds the difference that makes."""
    from gsmbench.reference import render

    cell = tiny("xr-stereo-1m.foveated", 20000, 48, 32)
    # large splats, so that tiles saturate and stop before their end
    cfg = dict(cell.config, camera=dict(cell.config["camera"], fov_deg=20.0),
               scene=dict(cell.config["scene"], scale_factor=6.0))
    scene = scene_mod.make_scene(cfg["scene"], 21, "cpu")
    pose = traffic.poses(cell.traffic, cfg["viewpoint"], 21)[0]
    from gsmbench.entries import render as mono

    a = mono.reference(Reference(scene, sh_degree=3, chunk=8), cfg, pose)
    monkeypatch.setattr(render, "BLOCK", 1)
    b = mono.reference(Reference(scene, sh_degree=3, chunk=8), cfg, pose)
    assert float(a.slack.max()) > 0.0  # some tiles saturate
    assert not torch.equal(a.color, b.color)  # and stop elsewhere
    assert float(((a.color - b.color).abs() - a.slack[..., None]).max()) <= 1e-5
    assert float(((a.depth - b.depth).abs() - a.slack_depth).max()) <= 1e-5
