"""The HardwareRenderer's stereo and foveated stereo frames in
gsm_renderer_tpu_torch (on the CPU: the plain PyTorch versions of the
kernels) against the JAX package's ``depth_first_stereo_frame`` and
``depth_first_stereo_foveated_frame`` with ``depth_mode="normalized"``
(Pallas in interpret mode, computed once per module), and against the
port's own DepthFirst frames.

Tolerances:
* against JAX: visible_count, total_instances and overflow equal; colour
  and alpha max |d| <= 1e-2 (the early-exit bound 1/255 plus theta
  flips); normalized depth <= 5e-2 where alpha > 0.05 (a small alpha
  magnifies the weighted depth's float noise elsewhere);
* against the port's DepthFirst frame of the same scene and rig: colour
  bit-equal, depth bit-equal to the DepthFirst depth divided by
  max(alpha, 1e-6), header equal (the Hardware stereo frames are the
  DepthFirst frames with normalized depth);
* ``render_stereo_foveated_compress``: the stereo frame resampled, as for
  DepthFirst.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu import stereo as JS
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.pipelines import depth_first as JD

import gsm_renderer_tpu_torch as T

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

W, H, N, NEAR, FAR = 96, 64, 250, 0.1, 20.0
COLOR_TOL, DEPTH_TOL = 1e-2, 5e-2
CAP = 8 * 4096
STATICS = dict(sh_degree=1, alpha_threshold=0.005, total_ink_threshold=2.0,
               near_plane=NEAR, far_plane=FAR, input_is_srgb=False,
               capacity=CAP)
FOV = dict(min_rate=0.4, radius=0.3)


@pytest.fixture(scope="module")
def scene():
    ds = jax_gen(N, sh_degree=1, seed=9, scale_range=(0.01, 0.08))
    js = G.make_side_by_side_stereo(G.make_camera(W, H, far=FAR), ipd=0.15)
    views = np.stack([js.left.view_matrix, js.right.view_matrix]).astype(np.float32)
    projs = np.stack([js.left.projection_matrix,
                      js.right.projection_matrix]).astype(np.float32)
    centers = np.stack([js.left.position, js.right.position]).astype(np.float32)
    gi = T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                               ds.opacities, ds.harmonics, device="cpu")
    ts = T.stereo_camera_from_numpy(views, projs, centers, NEAR, FAR, W, H)
    return dict(ds=ds, gi=gi, ts=ts, rig=(views, projs, centers))


@pytest.fixture(scope="module")
def jax_frames(scene):
    """JAX's stereo and foveated frames with normalized depth, as numpy."""
    views, projs, centers = (jnp.asarray(x) for x in scene["rig"])
    jgi, eye = scene["ds"].to_input(), jnp.eye(4, dtype=jnp.float32)
    stereo = JD.depth_first_stereo_frame(
        jgi, views, projs, centers, eye, width=W, height=H,
        depth_mode="normalized", interpret=True, **STATICS)
    t = JS.make_rate_maps(W, H, **FOV)
    tabs = JS.foveated_raster_tables(t)
    frame = functools.partial(
        JD.depth_first_stereo_foveated_frame, display_width=W,
        display_height=H, render_width=t.render_width,
        render_height=t.render_height, depth_mode="normalized",
        interpret=True, **STATICS)
    fov = jax.jit(frame)(jgi, views, projs, centers, eye,
                         jnp.asarray(tabs["inv_fit"]),
                         jnp.asarray(tabs["coord_x"]),
                         jnp.asarray(tabs["coord_y"]),
                         jnp.asarray(tabs["bounds"]))
    return {k: jax.tree_util.tree_map(np.asarray, v)
            for k, v in (("stereo", stereo), ("foveated", fov))}


def render(cls, frame, scene):
    r = cls(T.RendererConfig(sh_degree=1, max_width=W, max_height=H,
                             max_instances=CAP), device="cpu")
    if frame == "stereo":
        return r.render_stereo(scene["gi"], scene["ts"], W, H)
    return r.render_stereo_foveated(scene["gi"], scene["ts"],
                                    T.make_rate_maps(W, H, **FOV))


@pytest.mark.parametrize("frame", ["stereo", "foveated"])
def test_frame_matches_jax(scene, jax_frames, frame):
    ref = jax_frames[frame]
    got = render(T.HardwareRenderer, frame, scene)
    for f in ("visible_count", "total_instances", "overflow"):
        assert int(getattr(got.header, f)) == int(getattr(ref.header, f)), f
    assert int(got.header.overflow) == 0
    color, depth = got.color.numpy(), got.depth.numpy()
    assert color.shape == ref.color.shape and depth.shape == ref.depth.shape
    np.testing.assert_allclose(color, ref.color, atol=COLOR_TOL)
    seen = ref.color[..., 3] > 0.05
    assert seen.mean() > 0.1
    np.testing.assert_allclose(depth[seen], ref.depth[seen], atol=DEPTH_TOL)
    half = color.shape[1] // 2
    assert color[:, :half, :3].max() > 0.05 and color[:, half:, :3].max() > 0.05


@pytest.mark.parametrize("frame", ["stereo", "foveated"])
def test_frame_is_depth_first_with_normalized_depth(scene, frame):
    hw = render(T.HardwareRenderer, frame, scene)
    df = render(T.DepthFirstRenderer, frame, scene)
    assert torch.equal(hw.color, df.color)
    assert torch.equal(hw.depth, df.depth / df.color[..., 3].clamp_min(1e-6))
    for f in ("visible_count", "total_instances", "overflow", "slot_total"):
        assert int(getattr(hw.header, f)) == int(getattr(df.header, f)), f


def test_stereo_capacity_kinds(scene):
    """The Hardware stereo frames lock their capacity under their own kinds
    (JAX's "hw_stereo" and "hw_stereo_fov")."""
    r = T.HardwareRenderer(T.RendererConfig(sh_degree=1, max_width=W,
                                            max_height=H), device="cpu")
    target = T.make_rate_maps(W, H, **FOV)
    for _ in range(2):
        r.render_stereo(scene["gi"], scene["ts"], W, H)
        r.render_stereo_foveated(scene["gi"], scene["ts"], target)
    assert {k for k, _n in r._cap_state} == {"hw_stereo", "hw_stereo_fov"}


def test_foveated_compress(scene):
    """``render_stereo_foveated_compress``: the Hardware stereo frame
    resampled into the physical target."""
    r = T.HardwareRenderer(T.RendererConfig(sh_degree=1, max_width=W,
                                            max_height=H), device="cpu")
    target = T.make_rate_maps(W, H, **FOV)
    out = r.render_stereo_foveated_compress(scene["gi"], scene["ts"], target)
    full = r.render_stereo(scene["gi"], scene["ts"], W, H)
    assert torch.equal(out.color, T.compress_foveated(full.color, target))
    assert out.color.shape == (target.render_height, 2 * target.render_width, 4)
