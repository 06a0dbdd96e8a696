"""The mono frames of gsm_renderer_tpu_torch at tile sides over 64 pixels
(on the CPU: the plain PyTorch versions of the kernels) against the JAX
package's interpret-mode stages.

The port takes every tile side from 1 to 4096 pixels; on the card a tile
of more than 4096 pixels takes the blend's large-tile path (CTAs without a
cluster that find the tile's exit in a scan launch), whose images equal
the plain version's.  On the light scene of tests/test_torch_tiles.py
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
  4096 pixels a tile and none below (the launch monkeypatched).

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
    pixels the large-tile path's scratch (its last pointer) and any other
    tile none (it raises or launches before it touches a device)."""
    calls = []
    monkeypatch.setattr(TK.BLEND, "launch", lambda *a: calls.append(a))
    key = torch.arange(4, dtype=torch.int64)
    words = torch.zeros((4, 4), dtype=torch.int32)
    starts = counts = torch.zeros(1, dtype=torch.int32)
    for tile, large in (((64, 64), False), ((1, 4096), False),
                        ((65, 65), True), ((4096, 4096), True)):
        TK.blend_image_cuda(key, words, 32, starts, counts, tiles_x=1,
                            tiles_y=1, width=8, height=8, tile_w=tile[0],
                            tile_h=tile[1])
        assert calls[-1][11:13] == tile
        assert (calls[-1][-1] is not None) == large
    assert len(calls) == 4
