"""The stereo and foveated stereo frames of gsm_renderer_tpu_torch at other
tiles than 16x16 (on the CPU: the plain PyTorch versions of the kernels)
against the JAX package's interpret-mode frames.

On the scene and rig of tests/test_torch_hardware_stereo.py (250 gaussians,
96x64 an eye):

* the dual-eye packed projection at 8x8 and 32x16 against JAX's
  ``stereo_project_and_cull_packed``: union rect words, rect_h and depth
  words equal; record words equal but theta's u16, held as
  tests/test_torch_project.py holds it; the union pixel bounds within
  BOUNDS_TOL px (XLA contracts the OBB extents' multiply-adds; the frames
  below re-bin from them);
* ``depth_first_stereo_frame`` at 32x16 and 8x8, the foveated frame
  (``make_rate_maps(min_rate=0.4, radius=0.3)``, the tables of
  ``foveated_raster_tables`` at the frame's tile) at 32x16 and 8x8, and the
  Hardware stereo frame (normalized depth) at 8x8;
* the foveated tables themselves at 8x8 and 32x16, bit-equal to JAX's.

Tolerances (those of tests/test_torch_stereo.py and
tests/test_torch_foveated.py): visible_count, total_instances and overflow
equal; slot_total equal up to 32 slots for each of at most FLIP_CAP
gaussians whose tile test flips at a float boundary; colour and alpha max
|d| <= 1e-2; weighted depth <= 5e-2 (normalized depth where alpha > 0.05);
records differing beyond the theta bound capped at 0.2% of the gaussians.
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
from gsm_renderer_tpu.kernels.project import (
    stereo_project_and_cull_packed as jax_stereo_project)
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines import depth_first as JD

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import depth_first as TD

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

W, H, N, NEAR, FAR = 96, 64, 250, 0.1, 20.0
COLOR_TOL, DEPTH_TOL = 1e-2, 5e-2
FLIP_CAP = max(int(0.002 * N), 1)
THETA_TOL = 4.0
BOUNDS_TOL = 2e-3
CAP = 8 * 4096
STATICS = dict(sh_degree=1, alpha_threshold=0.005, total_ink_threshold=2.0,
               near_plane=NEAR, far_plane=FAR, input_is_srgb=False,
               capacity=CAP)
FOV = dict(min_rate=0.4, radius=0.3)
#: name -> (kind, tile_w, tile_h, depth mode)
FRAMES = {
    "stereo_32x16": ("stereo", 32, 16, "weighted"),
    "stereo_8x8": ("stereo", 8, 8, "weighted"),
    "foveated_32x16": ("foveated", 32, 16, "weighted"),
    "foveated_8x8": ("foveated", 8, 8, "weighted"),
    "hw_stereo_8x8": ("stereo", 8, 8, "normalized"),
}


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def theta_error(w1_ref, w1_got, w2_ref):
    """Cyclic theta difference in u16 units, weighted by the reference
    record's anisotropy (s1^2 - s2^2) / s1^2 (0 within +-1)."""
    def half(h):
        return np.asarray(h, np.uint16).view(np.float16).astype(np.float64)

    d = np.abs((w1_ref & 0xFFFF) - (w1_got & 0xFFFF))
    d = np.minimum(d, 65536 - d)
    s1, s2 = half(w1_ref >> 16), half(w2_ref & 0xFFFF)
    aniso = np.clip((s1 * s1 - s2 * s2) / np.maximum(s1 * s1, 1e-30), 0.0, 1.0)
    return np.where(d <= 1, 0.0, d * aniso)


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
    return dict(ds=ds, gi=gi, rig=(views, projs, centers),
                target=T.make_rate_maps(W, H, **FOV),
                jax_target=JS.make_rate_maps(W, H, **FOV))


def jax_frame(scene, kind, tile_w, tile_h, depth_mode):
    views, projs, centers = (jnp.asarray(x) for x in scene["rig"])
    jgi, eye = scene["ds"].to_input(), jnp.eye(4, dtype=jnp.float32)
    kw = dict(tile_w=tile_w, tile_h=tile_h, depth_mode=depth_mode,
              interpret=True, **STATICS)
    if kind == "stereo":
        out = JD.depth_first_stereo_frame(jgi, views, projs, centers, eye,
                                          width=W, height=H, **kw)
    else:
        t = scene["jax_target"]
        tabs = JS.foveated_raster_tables(t, tile_w, tile_h)
        frame = functools.partial(
            JD.depth_first_stereo_foveated_frame, display_width=W,
            display_height=H, render_width=t.render_width,
            render_height=t.render_height, **kw)
        out = jax.jit(frame)(jgi, views, projs, centers, eye,
                             *(jnp.asarray(tabs[k]) for k in
                               ("inv_fit", "coord_x", "coord_y", "bounds")))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def jax_frames(scene):
    return {name: jax_frame(scene, *spec) for name, spec in FRAMES.items()}


def port_frame(scene, kind, tile_w, tile_h, depth_mode):
    views, projs, centers = scene["rig"]
    eye = np.eye(4, dtype=np.float32)
    kw = dict(tile_w=tile_w, tile_h=tile_h, depth_mode=depth_mode, **STATICS)
    if kind == "stereo":
        return TD.depth_first_stereo_frame(scene["gi"], views, projs, centers,
                                           eye, width=W, height=H, **kw)
    t = scene["target"]
    tables = TD.foveated_device_tables(t, "cpu", tile_w, tile_h)
    return TD.depth_first_stereo_foveated_frame(
        scene["gi"], views, projs, centers, eye, tables, display_width=W,
        display_height=H, render_width=t.render_width,
        render_height=t.render_height, **kw)


@pytest.mark.parametrize("tile", [(8, 8), (32, 16)], ids=["8x8", "32x16"])
def test_stereo_projection_matches_pallas(scene, tile):
    views, projs, centers = scene["rig"]
    tiles_x, tiles_y = -(-W // tile[0]), -(-H // tile[1])
    kw = {k: v for k, v in STATICS.items() if k != "capacity"}
    kw.update(width=W, height=H, tile_w=tile[0], tile_h=tile[1])
    ref = jax_stereo_project(
        scene["ds"].to_input(), jnp.asarray(views), jnp.asarray(projs),
        jnp.asarray(centers), jnp.eye(4, dtype=jnp.float32), interpret=True,
        key_plan=JB.make_key_plan(tiles_x * tiles_y, N, near_plane=NEAR,
                                  far_plane=FAR), **kw)
    got = TP.stereo_project_and_cull_packed(
        scene["gi"], views, projs, centers, np.eye(4, dtype=np.float32),
        key_plan=TB.make_key_plan(tiles_x * tiles_y, N, near_plane=NEAR,
                                  far_plane=FAR), **kw)
    flips = np.zeros(N, bool)
    for name in ("rect_word", "rect_h", "dsw"):
        flips |= u32(getattr(got, name).numpy()) != u32(getattr(ref, name))
    for name in ("px_min", "px_max", "py_min", "py_max"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0.0, atol=BOUNDS_TOL)
    w = [u32(x.numpy()) for x in got.words]
    r = [u32(x) for x in ref.words]
    for k in (0, 2, 3, 4, 6, 7):
        flips |= w[k] != r[k]
    for k in (1, 5):
        flips |= (w[k] >> 16) != (r[k] >> 16)
        flips |= theta_error(r[k], w[k], r[k + 1]) > THETA_TOL
    assert flips.sum() <= FLIP_CAP, f"{flips.sum()} records differ"
    assert got.visible.sum() > N // 2


@pytest.mark.parametrize("tile", [(8, 8), (32, 16)], ids=["8x8", "32x16"])
def test_foveated_tables_match_jax(scene, tile):
    ref = JS.foveated_raster_tables(scene["jax_target"], *tile)
    got = TD.foveated_device_tables(scene["target"], "cpu", *tile)
    for name in ("coord_x", "coord_y", "bounds"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]))
    np.testing.assert_array_equal(got["inv_fit"], np.asarray(ref["inv_fit"]))
    assert got["coord_x"].shape[1] == tile[0] * tile[1]


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, jax_frames, name):
    kind, _tw, _th, depth_mode = FRAMES[name]
    ref = jax_frames[name]
    got = port_frame(scene, *FRAMES[name])
    for f in ("visible_count", "total_instances", "overflow"):
        assert int(getattr(got.header, f)) == int(getattr(ref.header, f)), f
    assert int(got.header.overflow) == 0 and got.header.row_total is None
    slot_diff = abs(int(got.header.slot_total) - int(ref.header.slot_total))
    assert slot_diff <= 32 * FLIP_CAP, slot_diff
    color, depth = got.color.numpy(), got.depth.numpy()
    assert color.shape == ref.color.shape and depth.shape == ref.depth.shape
    np.testing.assert_allclose(color, ref.color, atol=COLOR_TOL)
    if depth_mode == "normalized":
        seen = ref.color[..., 3] > 0.05
        np.testing.assert_allclose(depth[seen], ref.depth[seen], atol=DEPTH_TOL)
    else:
        np.testing.assert_allclose(depth, ref.depth, atol=DEPTH_TOL)
    half = color.shape[1] // 2
    assert color[:, :half, :3].max() > 0.05 and color[:, half:, :3].max() > 0.05


def test_foveated_frame_refuses_other_tables(scene):
    """The coordinate tables must be those of the frame's tile."""
    views, projs, centers = scene["rig"]
    t = scene["target"]
    tables = TD.foveated_device_tables(t, "cpu", 16, 16)
    with pytest.raises(ValueError, match="tables"):
        TD.depth_first_stereo_foveated_frame(
            scene["gi"], views, projs, centers, np.eye(4, dtype=np.float32),
            tables, display_width=W, display_height=H,
            render_width=t.render_width, render_height=t.render_height,
            tile_w=8, tile_h=8, **STATICS)


def test_foveated_grid_limit_raises_as_in_jax():
    """An 8-pixel tile on a 1080p-class physical grid passes the 127
    tiles an axis of the bounds table: both packages refuse it."""
    t = T.make_rate_maps(1920, 1080, **FOV)
    jt = JS.make_rate_maps(1920, 1080, **FOV)
    with pytest.raises(ValueError, match="127"):
        JS.foveated_raster_tables(jt, 8, 8)
    with pytest.raises(ValueError, match="127"):
        TD.foveated_device_tables(t, "cpu", 8, 8)
