"""The stereo and foveated stereo frames of gsm_renderer_tpu_torch at tile
sides that are not powers of two, and the two-eye blend without a cutoff
(on the CPU: the plain PyTorch versions of the kernels), against the JAX
package in interpret mode.

On the scene and rig of tests/test_torch_tiles_stereo.py (250 gaussians,
96x64 an eye):

* the dual-eye packed projection at 24x24 and 12x20 against JAX's
  ``stereo_project_and_cull_packed`` and the foveated tables at those
  tiles against JAX's ``foveated_raster_tables``;
* ``depth_first_stereo_frame`` and the foveated frame
  (``make_rate_maps(min_rate=0.4, radius=0.3)``) at 24x24 and 12x20;
* the two-eye blend without a cutoff (``n_eyes=2, r2_cutoff=0``, which no
  frame blends but the kernel function takes) against
  ``blend_tiles_pallas(n_eyes=2, r2_cutoff=0.0, interpret=True)`` on the
  stereo chain's sorted table at 24x24 and 16x16, weighted and first-hit
  depth.

Tolerances: those of tests/test_torch_tiles_stereo.py for the projection
and frames (visible_count, total_instances and overflow equal; slot_total
equal up to 32 slots for each of at most FLIP_CAP flipped gaussians;
colour within 1e-2, depth within 5e-2; pixel bounds within BOUNDS_TOL);
the blend of one sorted table as tests/test_torch_stereo.py holds the
dual-eye blend: max |d| <= 1e-5 in both eyes (first-hit depth equal up to
pixels whose alpha lies within float noise of the 0.1 threshold).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsm_renderer_tpu import stereo as JS
from gsm_renderer_tpu.kernels import blend as JK
from gsm_renderer_tpu.kernels.project import (
    stereo_project_and_cull_packed as jax_stereo_project)
from gsm_renderer_tpu.ops import binning as JB

from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import depth_first as TD
from gsm_renderer_tpu_torch.pipelines.common import sort_and_ranges

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tiles_stereo import (  # noqa: E402
    BOUNDS_TOL, COLOR_TOL, DEPTH_TOL, FLIP_CAP, STATICS, THETA_TOL, H, N,
    W, NEAR, FAR, jax_frame, port_frame, theta_error, u32)
from test_torch_tiles_stereo import scene  # noqa: E402,F401  (fixture)

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

TILES = [(24, 24), (12, 20)]
TILE_IDS = ["24x24", "12x20"]
#: name -> (kind, tile_w, tile_h, depth mode)
FRAMES = {
    "stereo_24x24": ("stereo", 24, 24, "weighted"),
    "stereo_12x20": ("stereo", 12, 20, "weighted"),
    "foveated_24x24": ("foveated", 24, 24, "weighted"),
    "foveated_12x20": ("foveated", 12, 20, "weighted"),
}


@pytest.fixture(scope="module")
def jax_frames(scene):  # noqa: F811
    return {name: jax_frame(scene, *spec) for name, spec in FRAMES.items()}


def check_stereo_projection(scene, tile):  # noqa: F811
    """The port's dual-eye packed projection at ``tile`` against JAX's."""
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


def check_foveated_tables(scene, tile):  # noqa: F811
    ref = JS.foveated_raster_tables(scene["jax_target"], *tile)
    got = TD.foveated_device_tables(scene["target"], "cpu", *tile)
    for name in ("coord_x", "coord_y", "bounds"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]))
    np.testing.assert_array_equal(got["inv_fit"], np.asarray(ref["inv_fit"]))
    assert got["coord_x"].shape[1] == tile[0] * tile[1]


def check_frame(scene, ref, spec):  # noqa: F811
    """The port's stereo or foveated frame of ``spec`` (kind, tile_w,
    tile_h, depth mode) against JAX's frame ``ref``."""
    got = port_frame(scene, *spec)
    for f in ("visible_count", "total_instances", "overflow"):
        assert int(getattr(got.header, f)) == int(getattr(ref.header, f)), f
    assert int(got.header.overflow) == 0 and got.header.row_total is None
    slot_diff = abs(int(got.header.slot_total) - int(ref.header.slot_total))
    assert slot_diff <= 32 * FLIP_CAP, slot_diff
    color, depth = got.color.numpy(), got.depth.numpy()
    assert color.shape == ref.color.shape and depth.shape == ref.depth.shape
    np.testing.assert_allclose(color, ref.color, atol=COLOR_TOL)
    np.testing.assert_allclose(depth, ref.depth, atol=DEPTH_TOL)
    half = color.shape[1] // 2
    assert color[:, :half, :3].max() > 0.05 and color[:, half:, :3].max() > 0.05


def sorted_stereo_table(scene, tile):  # noqa: F811
    """The port's stereo chain on the CPU at ``tile`` up to the ranges: the
    8 word rows gathered into sorted order, starts, counts, tiles_x,
    tiles_y."""
    views, projs, centers = scene["rig"]
    tiles_x, tiles_y = -(-W // tile[0]), -(-H // tile[1])
    plan = TB.make_key_plan(tiles_x * tiles_y, N, near_plane=NEAR,
                            far_plane=FAR)
    _pp, keys, words, slot_total, overflow, _sums = TD._stereo_packed_ops(
        scene["gi"], views, projs, centers, np.eye(4, dtype=np.float32), None,
        plan, width=W, height=H, capacity=STATICS["capacity"], tiles_x=tiles_x,
        tile_w=tile[0], tile_h=tile[1],
        **{k: v for k, v in STATICS.items() if k != "capacity"})
    assert int(overflow) == 0
    srt = sort_and_ranges(keys, plan, tiles_x * tiles_y)
    entry = TK.entry_index(srt.key, srt.idx_bits).clamp(max=N - 1)
    table = torch.stack([w[entry] for w in words])
    return table, srt.starts, srt.counts, tiles_x, tiles_y


def check_two_eye_blend_without_cutoff(scene, tile, depth_mode):  # noqa: F811
    """The plain two-eye blend without a cutoff of the port's sorted stereo
    table at ``tile`` against ``blend_tiles_pallas(n_eyes=2,
    r2_cutoff=0.0, interpret=True)`` on the same table."""
    table, starts, counts, tiles_x, tiles_y = sorted_stereo_table(scene, tile)
    cap = table.shape[1]
    kw = dict(tile_w=tile[0], tile_h=tile[1], n_eyes=2, r2_cutoff=0.0,
              depth_mode=depth_mode)
    ref = JK.blend_tiles_pallas(
        JK.build_words_table([jnp.asarray(r.numpy()) for r in table], cap),
        jnp.asarray(starts.numpy()), jnp.asarray(counts.numpy()),
        tiles_x=tiles_x, tiles_y=tiles_y, interpret=True, **kw)
    got = TK.blend_tiles_plain(torch.arange(cap, dtype=torch.int64), table,
                               32, starts, counts, tiles_x=tiles_x, **kw)
    for (rc, rd), (gc, gd) in zip(ref, got):
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
        if depth_mode == "weighted":
            np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-5)
        else:
            flips = np.abs(gd.numpy() - np.asarray(rd)) > 1e-5
            assert flips.sum() <= 0.005 * flips.size, f"{flips.sum()} flips"
    # without the cutoff the faint skirt past q = 9 reaches more pixels
    cut = TK.blend_tiles_plain(torch.arange(cap, dtype=torch.int64), table,
                               32, starts, counts, tiles_x=tiles_x,
                               **dict(kw, r2_cutoff=9.0))
    lit = [int((c[..., 3] > 0).sum()) for c, _ in got]
    assert all(n > int((c[..., 3] > 0).sum()) for n, (c, _) in zip(lit, cut))


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_stereo_projection_matches_pallas(scene, tile):  # noqa: F811
    check_stereo_projection(scene, tile)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_foveated_tables_match_jax(scene, tile):  # noqa: F811
    check_foveated_tables(scene, tile)


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, jax_frames, name):  # noqa: F811
    check_frame(scene, jax_frames[name], FRAMES[name])


@pytest.mark.parametrize("depth_mode", ["weighted", "first_hit"])
@pytest.mark.parametrize("tile", [(24, 24), (16, 16)], ids=["24x24", "16x16"])
def test_two_eye_blend_without_cutoff_matches_pallas(scene, tile,  # noqa: F811
                                                     depth_mode):
    check_two_eye_blend_without_cutoff(scene, tile, depth_mode)
