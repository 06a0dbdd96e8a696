"""The mono frames of gsm_renderer_tpu_torch at tile sides over 64 pixels
(on the CPU: the plain PyTorch versions of the kernels) against the JAX
package's interpret-mode stages.

The port takes every tile side from 1 to 4096 pixels; on the card a tile
of more than 4096 pixels takes the blend's large-tile path (CTAs without a
cluster that blend to their own exits, then resume to the tile's), whose
images equal the plain version's.  On the light scene of tests/test_torch_tiles.py
(300 gaussians at 128x96) and on its heavy-tailed scene drawn at 256x384
("tall": five 80-pixel tile rows, so that rects outgrow the 8x4 window at
96x80 tiles and the row decomposition has rows to narrow):

* the tile rect: ``mathlib.compute_tile_bounds_c`` against JAX's under
  ``jax.jit`` with static sides 65, 80, 96, 100, 200 and 1000 (200k random
  bounds and every integer);
* stages, each fed the JAX stage's own inputs, at 128x96 (one tile holds
  the frame), 80x72, 96x80 with the row decomposition (tall scene) and
  256x256 (one tile larger than the frame): the packed projection, prep,
  the row table, the expand and the blend of JAX's sorted table (through
  the identity key);
* the port's rows-on frame at 96x80 (tall scene) bit-equal to rows off;
* the longest sides (4096x1, 1x4096) against tests/reference_impl.py;
* the CUDA blend's wrapper passes its launch the large-tile scratch above
  4096 pixels a tile and none below (the launch monkeypatched), and a
  large tile's exit is the latest of its CTAs' own (the plain version's
  steps).

tests/test_torch_tiles_large_frames.py holds the DepthFirst frames at
these tiles against JAX's, tests/test_torch_tiles_large_d16.py the Local
and Global frames.  Tolerances: those of tests/test_torch_tiles.py (see
tests/test_torch_tiles_odd.py, whose checks this file runs).  JAX's stages
are computed once per module.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen

from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from reference_impl import render_reference  # noqa: E402
from test_torch_tiles import (  # noqa: E402
    COLOR_TOL, DEPTH_TOL, HEAVY_CAP, N, NEAR, FAR, ROWS, STATICS, H, W,
    make_scene)
from test_torch_tiles_odd import (  # noqa: E402
    check_blend, check_expand, check_prep, check_projection, check_row_table,
    jax_stages, jax_tile_bounds, port_tile_bounds)

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

#: the tall scene's frame: 3 x 5 tiles of 96x80
TW, TH = 256, 384
#: (tile_w, tile_h, row capacity) of the stage fixture; rows on the tall
#: scene
STAGE_TILES = [(128, 96, 0), (80, 72, 0), (96, 80, ROWS), (256, 256, 0)]
STAGE_IDS = [f"{w}x{h}" + ("_rows" if r else "") for w, h, r in STAGE_TILES]


@pytest.fixture(scope="module")
def scene():
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.06)), W, H)


@pytest.fixture(scope="module")
def tall():
    return tall_scene()


def tall_scene():
    """The heavy-tailed scene of tests/test_torch_tiles.py at TW x TH."""
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.6),
                              seed=13), TW, TH)


@pytest.fixture(scope="module")
def stages(scene, tall):
    return jax_stages(scene, tall, STAGE_TILES)


@pytest.mark.parametrize("side", [65, 80, 96, 100, 200, 1000])
def test_tile_bounds_round_as_jitted_jax(side):
    rng = np.random.default_rng(side)
    x = np.concatenate([rng.uniform(0, 3999, 200_000).astype(np.float32),
                        np.arange(0, 3999, dtype=np.float32)])
    for got, want in zip(port_tile_bounds(x, side), jax_tile_bounds(x, side)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_projection_matches_pallas(scene, tall, stages, tile):
    ref = stages[tile]
    check_projection(tall if ref["rows"] else scene, ref, tile)


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_prep_matches_pallas(stages, tile):
    check_prep(stages[tile], tile)


def test_row_table_matches_pallas(stages):
    check_row_table(stages[(96, 80)], (96, 80))


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_expand_matches_pallas(stages, tile):
    check_expand(stages[tile], tile)


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_blend_matches_pallas(stages, tile):
    check_blend(stages[tile], tile)


def test_rows_frame_bit_equal_to_rows_off(tall):
    """Rows narrow the slots, not the image, at 96x80."""
    kw = dict(STATICS, **tall["size"], tile_w=96, tile_h=80,
              capacity=HEAVY_CAP)
    on = depth_first_frame(tall["gi"], *tall["port_args"], row_capacity=ROWS,
                           **kw)
    off = depth_first_frame(tall["gi"], *tall["port_args"], **kw)
    assert torch.equal(on.color, off.color)
    assert torch.equal(on.depth, off.depth)
    assert int(on.header.slot_total) < int(off.header.slot_total)


@pytest.mark.parametrize("tile", [(4096, 1), (1, 4096)],
                         ids=["4096x1", "1x4096"])
def test_longest_sides_match_the_reference(scene, tile):
    """The longest sides against tests/reference_impl.py at the same tile
    (its per-pixel exit differs from the blend's batched tile exit by less
    than 1/255): visible gaussians and instances equal, colour and depth
    within the frame tolerances."""
    color, depth, aux = render_reference(
        scene["ds"], *scene["port_args"], W, H, sh_degree=1, tile_w=tile[0],
        tile_h=tile[1], near=NEAR, far=FAR)
    got = depth_first_frame(scene["gi"], *scene["port_args"], tile_w=tile[0],
                            tile_h=tile[1], **dict(STATICS, **scene["size"]))
    assert int(got.header.overflow) == 0
    assert int(got.header.visible_count) == aux["visible"]
    assert int(got.header.total_instances) == aux["total_instances"]
    np.testing.assert_allclose(got.color.numpy(), color, atol=COLOR_TOL)
    np.testing.assert_allclose(got.depth.numpy(), depth, atol=DEPTH_TOL)
    assert float(color[..., :3].max()) > 0.05


def test_blend_cuda_wrapper_gives_large_tiles_their_scratch(monkeypatch):
    """The kernel's wrapper hands a tile of more than CLUSTER_MAX_PIXELS
    pixels the large-tile path's operands (its last three pointers):
    exits, int32, a word a tile and one for each of the CTAs a tile that
    the kernel's layout query reports (``split_layout``, stubbed here: it
    needs the built library); state, int32 (height, n_eyes * width, 2);
    the tiles by record count, the most first; and any other tile none,
    without asking the layout (it raises or launches before it touches a
    device)."""
    calls, scratch, asked = [], [], []
    monkeypatch.setattr(TK.BLEND, "launch", lambda *a: calls.append(a))
    real = TK.large_operands
    monkeypatch.setattr(TK, "large_operands",
                        lambda *a: scratch.append(real(*a)) or scratch[-1])

    def layout(n_eyes, r2_cutoff, tw, th):
        asked.append((n_eyes, r2_cutoff, tw, th))
        return 8, 8, tw % 7 + 3, 1
    monkeypatch.setattr(TK, "split_layout", layout)
    key = torch.arange(4, dtype=torch.int64)
    starts = torch.zeros(6, dtype=torch.int32)
    counts = torch.tensor([4, 1, 3, 0, 0, 0], dtype=torch.int32)
    for tile, eyes, large in (((64, 64), 1, False), ((1, 4096), 1, False),
                              ((65, 65), 1, True), ((4096, 4096), 1, True),
                              ((96, 96), 2, True), ((24, 24), 2, False)):
        words = torch.zeros((4 * eyes, 4), dtype=torch.int32)
        r2 = 9.0 if eyes == 2 else 0.0
        TK.blend_image_cuda(key, words, 32, starts, counts, tiles_x=3,
                            tiles_y=2, width=8, height=5, tile_w=tile[0],
                            tile_h=tile[1], n_eyes=eyes, r2_cutoff=r2)
        assert calls[-1][11:14] == (*tile, TK.DEPTH_MODES["weighted"])
        assert all((p is not None) == large for p in calls[-1][-3:])
        if not large:
            assert scratch[-1] is None
            continue
        assert asked[-1] == (eyes, r2, *tile)
        exits, state, order = scratch[-1]
        assert exits.dtype == state.dtype == order.dtype == torch.int32
        assert tuple(exits.shape) == (6 * (1 + tile[0] % 7 + 3),)
        assert tuple(state.shape) == (5, eyes * 8, 2)
        assert torch.equal(order, torch.tensor([0, 2, 1, 3, 4, 5],
                                               dtype=torch.int32))
    assert len(calls) == len(scratch) == 6 and len(asked) == 3


def test_large_tile_exits_at_its_latest_cta_exit(monkeypatch):
    """The large-tile path's schedule on the plain version's float steps: on
    a 64x72 tile (18 CTAs of 256 pixels) whose records
    crowd its top, so that its CTAs' pixels fall below the exit at
    different batches, each CTA blended alone (its pixels as a tile of
    their own, through pixel coordinates) stops at its own batch end, the
    tile stops at the latest of them, and a CTA that goes on from its own
    exit to the tile's (its pixels blended alone to that rank, the exit
    off) ends bit-equal to the whole tile's blend."""
    rng = np.random.default_rng(4)
    n = 1500
    f16 = lambda a: np.asarray(a, np.float16).view(np.uint16).astype(np.uint32)
    u8 = lambda lo, hi: rng.integers(lo, hi, n).astype(np.uint32)
    words = np.stack([
        f16(rng.uniform(-4, 68, n)) | f16(72 * rng.uniform(0, 1, n) ** 3) << 16,
        u8(0, 1 << 16) | f16(rng.uniform(2, 9, n)) << 16,
        f16(rng.uniform(2, 9, n)) | f16(rng.uniform(1, 40, n)) << 16,
        u8(0, 256) | u8(0, 256) << 8 | u8(0, 256) << 16 | u8(60, 256) << 24])
    words = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    key = torch.arange(n, dtype=torch.int64)
    tw, th = 64, 72
    # 18 CTAs of 8 warps over 8x4 warp blocks (the argument holds for any
    # partition of the tile's pixels into CTAs)
    ctas, cta_warps = 18, 8
    gw = torch.arange(ctas * cta_warps * 32) // 32
    lane = torch.arange(ctas * cta_warps * 32) % 32
    lx = (gw % 8) * 8 + lane % 8
    ly = torch.div(gw, 8, rounding_mode="floor") * 4 + \
        torch.div(lane, 8, rounding_mode="floor")
    assert torch.equal(torch.sort(ly * tw + lx).values,
                       torch.arange(tw * th))
    one = torch.zeros(1, dtype=torch.int32)
    color, depth, done = TK.blend_tiles_plain(
        key, words, 32, one, one + n, tiles_x=1, tile_w=tw, tile_h=th,
        return_processed=True)
    # CTA g as the diagonal tile (g, g) of a grid of one-row tiles
    coords = (lx.reshape(ctas, -1).float(), ly.reshape(ctas, -1).float())
    span = torch.zeros(ctas * ctas, dtype=torch.int32)
    diag = torch.arange(ctas) * (ctas + 1)

    def alone(count):
        return TK.blend_tiles_plain(
            key, words, 32, span, span + count, tiles_x=ctas,
            tile_w=cta_warps * 32, tile_h=1, tiles=diag, pixel_coords=coords,
            return_processed=True)

    own = alone(n)[2]
    assert int(done) < n and len(set(own.tolist())) > 2
    assert int(own.max()) == int(done[0])
    monkeypatch.setattr(TK, "MIN_TRANSMITTANCE", 0.0)
    c_res, d_res, _ = alone(int(done[0]))
    p = ly * tw + lx
    assert torch.equal(c_res.reshape(-1, 4), color[0][p])
    assert torch.equal(d_res.reshape(-1), depth[0][p])
