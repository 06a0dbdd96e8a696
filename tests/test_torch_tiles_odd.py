"""The mono frames of gsm_renderer_tpu_torch at tile sides that are not
powers of two (on the CPU: the plain PyTorch versions of the kernels)
against the JAX package's interpret-mode stages and frames.

The port takes every tile side from 1 to 64 pixels.  On the scenes of
tests/test_torch_tiles.py (300 gaussians: a light one at 128x96 and a
heavy-tailed one at 256x192 for the row decomposition):

* the tile rect: ``mathlib.compute_tile_bounds_c`` against JAX's under
  ``jax.jit`` with static sides (XLA folds the division by the constant
  side into a multiply by its float32 reciprocal, which rounds three
  known bounds to the next tile at sides 24 and 12), at 24, 12 and 48;
* stages, each fed the JAX stage's own inputs, at 24x24 and 48x16 with
  the row decomposition, and at 12x20, 7x5 and 64x64: the packed
  projection, prep, the row table, the expand and the blend of JAX's
  sorted table (through the identity key);
* frames: ``depth_first_frame`` at 24x24 and 7x5, with rows at
  12x20 and 48x16, the Hardware frame at 12x20, ``local_frame`` at 24x24
  and ``global_frame`` at 48x16;
* the extreme sides (1x1, 1x64, 64x1, 63x9) against
  tests/reference_impl.py at the same tile.

Tolerances: those of tests/test_torch_tiles.py (integer outputs equal up
to float-boundary flips capped at 0.2% of the gaussians; blended tiles of
one sorted table within 1e-5 in colour and 1e-4 in depth; frames with
every header field equal, colour within 1e-2, depth within 5e-2,
normalized depth where alpha > 0.05, first-hit depth flips capped at 0.5%
of the pixels).  JAX's stages and frames are computed once per module.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gsm_renderer_tpu import mathlib as JM
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.kernels import blend as JK
from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.kernels.project import project_and_cull_packed as jax_project
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines.common import binning_sorted_tile as jax_sorted_tile
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_df
from gsm_renderer_tpu.pipelines.global_ import global_frame as jax_global
from gsm_renderer_tpu.pipelines.local import local_frame as jax_local

from gsm_renderer_tpu_torch import mathlib as TM
from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame
from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
from gsm_renderer_tpu_torch.pipelines.local import local_frame

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from reference_impl import render_reference  # noqa: E402
from test_torch_tiles import (  # noqa: E402
    COLOR_TOL, DEPTH_TOL, FLIP_CAP, HEADER, HEAVY_CAP, HH, HW, NEAR, FAR, N,
    PROJ, ROWS, STATICS, THETA_TOL, H, W, header, i32, make_scene,
    theta_error, u32)

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

#: (tile_w, tile_h, row capacity) of the stage fixture; rows on the heavy
#: scene
STAGE_TILES = [(24, 24, ROWS), (12, 20, 0), (7, 5, 0), (48, 16, ROWS),
               (64, 64, 0)]
STAGE_IDS = [f"{w}x{h}" + ("_rows" if r else "") for w, h, r in STAGE_TILES]
#: name -> (JAX frame, port frame, keyword arguments)
FRAMES = {
    "df_24x24": (jax_df, depth_first_frame, dict(tile_w=24, tile_h=24)),
    "df_7x5": (jax_df, depth_first_frame, dict(tile_w=7, tile_h=5)),
    "rows_12x20": (jax_df, depth_first_frame,
                   dict(tile_w=12, tile_h=20, row_capacity=ROWS,
                        capacity=HEAVY_CAP)),
    "rows_48x16": (jax_df, depth_first_frame,
                   dict(tile_w=48, tile_h=16, row_capacity=ROWS,
                        capacity=HEAVY_CAP)),
    "hardware_12x20": (jax_df, depth_first_frame,
                       dict(tile_w=12, tile_h=20, exact_tile_test=False,
                            depth_mode="normalized", r2_cutoff=9.0)),
    "local_24x24": (jax_local, local_frame, dict(tile_w=24, tile_h=24)),
    "global_48x16": (jax_global, global_frame, dict(tile_w=48, tile_h=16)),
}
#: rect bounds that a float32 reciprocal multiply floors to the next tile
#: at sides 24 and 12, where an exact division does not
FLIP_VALUES = np.array([791.99994, 983.99994, 1847.9999], np.float32)


@pytest.fixture(scope="module")
def scene():
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.06)), W, H)


@pytest.fixture(scope="module")
def heavy():
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.6),
                              seed=13), HW, HH)


def jax_stages(scene, heavy, stage_tiles):
    """The JAX Pallas chain (interpret mode) at each (tile_w, tile_h, row
    capacity) of ``stage_tiles``, as numpy: packed projection, prep table,
    row table, expand, sort, ranges and the blend of the sorted table; rows
    on the ``heavy`` scene."""
    out = {}
    for tile_w, tile_h, rows in stage_tiles:
        sc = heavy if rows else scene
        tiles_x, tiles_y = -(-sc["w"] // tile_w), -(-sc["h"] // tile_h)
        plan = JB.make_key_plan(tiles_x * tiles_y, rows or N, near_plane=NEAR,
                                far_plane=FAR)
        kw = dict(tile_w=tile_w, tile_h=tile_h)
        packed = jax_project(sc["jgi"], *sc["jax_args"], key_plan=plan,
                             interpret=True, **kw, **{**PROJ, **sc["size"]})
        tab = JE.binning_prep_pallas(packed.rect_word, packed.rect_h,
                                     packed.dsw, packed.words, interpret=True,
                                     count_rows=rows > 0, **kw)
        prep = np.asarray(tab).reshape(tab.shape[0], -1)
        n_tab, row_tab = N, None
        if rows:
            tab, _ov = JE.row_expand_pallas(tab, n=N, row_capacity=rows,
                                            interpret=True, **kw)
            row_tab = np.asarray(tab).reshape(tab.shape[0], -1)
            n_tab = rows
        flat = np.asarray(tab).reshape(tab.shape[0], -1)
        cap = (int(flat[0, n_tab]) // 4096 + 1) * 4096
        outs = JE.expand_slots_pallas(
            None, None, None, capacity=cap, tiles_x=tiles_x, exact_test=True,
            prebuilt_tab=tab, n_gaussians=n_tab, key_plan=plan.kernel_tuple,
            interpret=True, **kw)
        srt = jax.lax.sort(tuple(outs[:6]), num_keys=2, is_stable=False)
        sorted_tile = jax_sorted_tile(srt[0], fused_depth16=False,
                                      plan_tuple=plan.kernel_tuple)
        starts, counts = JB.extract_tile_ranges(sorted_tile, tiles_x * tiles_y)
        wtable = JK.build_words_table(list(srt[2:6]), cap)
        tc, td = JK.blend_tiles_pallas(wtable, starts, counts, tiles_x=tiles_x,
                                       tiles_y=tiles_y, interpret=True, **kw)
        out[(tile_w, tile_h)] = dict(
            rows=rows, tiles_x=tiles_x, tiles_y=tiles_y, plan=plan, cap=cap,
            packed=dict(rect_word=np.asarray(packed.rect_word),
                        rect_h=np.asarray(packed.rect_h),
                        dsw=np.asarray(packed.dsw),
                        words=[np.asarray(w) for w in packed.words]),
            prep=prep, row_tab=row_tab, flat=flat, n_tab=n_tab,
            expand=[np.asarray(o) for o in outs],
            sorted_words=[np.asarray(w) for w in srt[2:6]],
            starts=np.asarray(starts), counts=np.asarray(counts),
            color=np.asarray(tc), depth=np.asarray(td))
    return out


def jax_frames_of(scene, heavy, frames):
    """JAX's interpret-mode frame of each entry of ``frames`` (name ->
    (JAX frame, port frame, keywords); names starting "rows" on the
    ``heavy`` scene), as numpy."""
    out = {}
    for name, (jfn, _pfn, kw) in frames.items():
        sc = heavy if name.startswith("rows") else scene
        out[name] = jax.tree_util.tree_map(
            np.asarray, jfn(sc["jgi"], *sc["jax_args"], interpret=True,
                            **{**STATICS, **sc["size"], **kw}))
    return out


@pytest.fixture(scope="module")
def stages(scene, heavy):
    return jax_stages(scene, heavy, STAGE_TILES)


@pytest.fixture(scope="module")
def jax_frames(scene, heavy):
    return jax_frames_of(scene, heavy, FRAMES)


def jax_tile_bounds(x, side):
    """JAX's tile rect of the points x (zero extents) under jax.jit with
    the side static, as the frame functions compute it."""
    fn = jax.jit(functools.partial(
        JM.compute_tile_bounds_c, width=4000.0, height=4000.0, tile_w=side,
        tile_h=side, tiles_x=4000, tiles_y=4000))
    zero = np.zeros_like(x)
    return [np.asarray(b) for b in fn(x, x, zero, zero)]


def port_tile_bounds(x, side):
    t, zero = torch.from_numpy(x), torch.zeros(x.shape)
    return [b.numpy() for b in TM.compute_tile_bounds_c(
        t, t, zero, zero, 4000.0, 4000.0, side, side, 4000, 4000)]


@pytest.mark.parametrize("side", [24, 12, 48])
def test_tile_bounds_round_as_jitted_jax(side):
    """The rect of the flip values and of 200k random bounds equals JAX's
    jitted rect; at 24 and 12 the flip values floor to the tile an exact
    division would not reach."""
    rng = np.random.default_rng(side)
    x = np.concatenate([FLIP_VALUES, rng.uniform(0, 3999, 200_000).astype(
        np.float32), np.arange(0, 3999, dtype=np.float32)])
    for got, want in zip(port_tile_bounds(x, side), jax_tile_bounds(x, side)):
        np.testing.assert_array_equal(got, want)
    exact = np.floor(FLIP_VALUES / np.float32(side)).astype(np.int32)
    flipped = port_tile_bounds(FLIP_VALUES, side)[0] != exact
    assert flipped.all() if side in (24, 12) else not flipped.any()


def check_projection(sc, ref, tile):
    """The port's packed projection on ``sc`` against JAX's (``ref``, a
    :func:`jax_stages` entry)."""
    got = TP.project_and_cull_packed(
        sc["gi"], *sc["port_args"], tile_w=tile[0], tile_h=tile[1],
        key_plan=TB.make_key_plan(ref["tiles_x"] * ref["tiles_y"],
                                  ref["rows"] or N, near_plane=NEAR,
                                  far_plane=FAR), **{**PROJ, **sc["size"]})
    p = ref["packed"]
    flips = np.zeros(N, bool)
    for name in ("rect_word", "rect_h", "dsw"):
        flips |= u32(getattr(got, name).numpy()) != u32(p[name])
    w = [u32(x.numpy()) for x in got.words]
    r = [u32(x) for x in p["words"]]
    for k in (0, 2, 3):
        flips |= w[k] != r[k]
    flips |= (w[1] >> 16) != (r[1] >> 16)
    flips |= theta_error(r[1], w[1], r[2]) > THETA_TOL
    assert flips.sum() <= FLIP_CAP, f"{flips.sum()} records differ"
    visible = (u32(p["rect_word"]) & TE.CULLED_BIT) == 0
    assert visible.sum() > N // 3


def check_prep(ref, tile):
    p, prep = ref["packed"], ref["prep"]
    offsets, rect, mask = TE.binning_prep(
        i32(p["rect_word"]), i32(p["rect_h"]), [i32(w) for w in p["words"]],
        tile_w=tile[0], tile_h=tile[1], count_rows=ref["rows"] > 0)
    flips = u32(mask.numpy()) != u32(prep[2, :N])
    assert flips.sum() <= FLIP_CAP, f"{flips.sum()} mask flips"
    same = ~flips
    np.testing.assert_array_equal(u32(rect.numpy())[same], u32(prep[1, :N])[same])
    cnt_ref = np.diff(prep[0, :N + 1].astype(np.int64))
    cnt_got = np.diff(offsets.numpy().astype(np.int64))
    np.testing.assert_array_equal(cnt_got[same], cnt_ref[same])
    if not flips.any():
        np.testing.assert_array_equal(offsets.numpy(), prep[0, :N + 1])
    masked = (u32(rect.numpy()) & TE.MASKED_BIT) != 0
    assert masked.sum() > N // 10  # the window pre-counts at this tile


def check_row_table(ref, tile):
    """The row decomposition on JAX's count_rows prep table: the row span
    multiplies by the float32 reciprocal of the side in both packages."""
    prep, rows = ref["prep"], ref["row_tab"]
    off2, rect2, mask2, dsw2, words2, ov = TE.row_expand(
        i32(prep[0, :N + 1]), i32(prep[1, :N]), i32(prep[2, :N]),
        i32(prep[3, :N]), [i32(prep[4 + k, :N]) for k in range(4)],
        row_capacity=ROWS, tile_w=tile[0], tile_h=tile[1])
    assert int(ov) == 0
    np.testing.assert_array_equal(off2.numpy(), rows[0, :ROWS + 1])
    for k, got in enumerate([rect2, mask2, dsw2] + words2):
        np.testing.assert_array_equal(u32(got.numpy()), u32(rows[1 + k, :ROWS]),
                                      err_msg=f"plane {1 + k}")
    oversized = (u32(prep[1, :N]) & (TE.MASKED_BIT | TE.CULLED_BIT)) == 0
    assert oversized.any()  # rect rows exercised at this tile


def check_expand(ref, tile):
    flat, n = ref["flat"], ref["n_tab"]
    key1, key2, total, overflow = TE.expand_slots(
        i32(flat[0, :n + 1]), i32(flat[1, :n]), i32(flat[2, :n]),
        i32(flat[3, :n]), [i32(flat[4 + k, :n]) for k in range(4)],
        capacity=ref["cap"], tiles_x=ref["tiles_x"], key_plan=ref["plan"],
        tile_w=tile[0], tile_h=tile[1])
    exp = ref["expand"]
    np.testing.assert_array_equal(u32(key1.numpy()), u32(exp[0]))
    np.testing.assert_array_equal(u32(key2.numpy()), u32(exp[1]))
    assert int(total) == int(exp[6]) and int(overflow) == int(exp[7]) == 0
    live = u32(key1.numpy()) != TE.SENTINEL
    entry = u32(key2.numpy())[live] & ((1 << ref["plan"].idx_bits) - 1)
    for k in range(4):  # the entries' words are the words JAX carries
        np.testing.assert_array_equal(u32(flat[4 + k, :n])[entry],
                                      u32(exp[2 + k])[live])
    assert live.sum() > N // 2


def check_blend(ref, tile):
    """The blend of JAX's sorted table, read through the identity key."""
    sw = torch.stack([i32(w) for w in ref["sorted_words"]])
    color, depth = TK.blend_tiles_plain(
        torch.arange(ref["cap"], dtype=torch.int64), sw, 32,
        torch.from_numpy(ref["starts"].copy()),
        torch.from_numpy(ref["counts"].copy()),
        tiles_x=ref["tiles_x"], tile_w=tile[0], tile_h=tile[1])
    assert color.shape == (ref["tiles_x"] * ref["tiles_y"], tile[0] * tile[1], 4)
    np.testing.assert_allclose(color.numpy(), ref["color"], atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), ref["depth"], atol=1e-4)
    assert float(color[..., :3].max()) > 0.05


def check_frame(sc, ref, name, pfn, kw):
    """The port's frame ``pfn`` on ``sc`` against JAX's frame ``ref``; the
    depth tolerance by the name's kind (local: first-hit flips; hardware:
    normalized depth where alpha > 0.05)."""
    got = pfn(sc["gi"], *sc["port_args"], **{**STATICS, **sc["size"], **kw})
    gh, rh = header(got), {f: (None if getattr(ref.header, f) is None
                               else int(getattr(ref.header, f)))
                           for f in HEADER}
    assert gh == rh
    assert gh["overflow"] == 0
    color, depth = got.color.numpy(), got.depth.numpy()
    assert color.shape == (sc["h"], sc["w"], 4) == ref.color.shape
    np.testing.assert_allclose(color, ref.color, atol=COLOR_TOL)
    if name.startswith("local"):
        flips = np.abs(depth - ref.depth) > DEPTH_TOL
        assert flips.sum() <= 0.005 * depth.size, f"{flips.sum()} depth flips"
    elif name.startswith("hardware"):
        seen = ref.color[..., 3] > 0.05
        np.testing.assert_allclose(depth[seen], ref.depth[seen], atol=DEPTH_TOL)
    else:
        np.testing.assert_allclose(depth, ref.depth, atol=DEPTH_TOL)
    assert float(color[..., :3].max()) > 0.05


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_projection_matches_pallas(scene, heavy, stages, tile):
    ref = stages[tile]
    check_projection(heavy if ref["rows"] else scene, ref, tile)


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_prep_matches_pallas(stages, tile):
    check_prep(stages[tile], tile)


@pytest.mark.parametrize("tile", [(w, h) for w, h, r in STAGE_TILES if r],
                         ids=[i for i, (_w, _h, r) in zip(STAGE_IDS, STAGE_TILES)
                              if r])
def test_row_table_matches_pallas(stages, tile):
    check_row_table(stages[tile], tile)


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_expand_matches_pallas(stages, tile):
    check_expand(stages[tile], tile)


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_blend_matches_pallas(stages, tile):
    check_blend(stages[tile], tile)


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, heavy, jax_frames, name):
    _jfn, pfn, kw = FRAMES[name]
    check_frame(heavy if name.startswith("rows") else scene,
                jax_frames[name], name, pfn, kw)


def test_rows_frames_bit_equal_to_rows_off(heavy):
    """Rows narrow the slots, not the image, at 12x20 and 48x16 too."""
    for tile_w, tile_h in ((12, 20), (48, 16)):
        kw = dict(STATICS, **heavy["size"], tile_w=tile_w, tile_h=tile_h,
                  capacity=HEAVY_CAP)
        on = depth_first_frame(heavy["gi"], *heavy["port_args"],
                               row_capacity=ROWS, **kw)
        off = depth_first_frame(heavy["gi"], *heavy["port_args"], **kw)
        assert torch.equal(on.color, off.color)
        assert torch.equal(on.depth, off.depth)
        assert int(on.header.slot_total) < int(off.header.slot_total)


@pytest.mark.parametrize("tile", [(1, 1), (1, 64), (64, 1), (63, 9)],
                         ids=["1x1", "1x64", "64x1", "63x9"])
def test_extreme_sides_match_the_reference(scene, tile):
    """The smallest and largest sides against tests/reference_impl.py at
    the same tile (its per-pixel exit differs from the blend's batched
    tile exit by less than 1/255): visible gaussians and instances equal,
    colour and depth within the frame tolerances above."""
    color, depth, aux = render_reference(
        scene["ds"], *scene["port_args"], W, H, sh_degree=1, tile_w=tile[0],
        tile_h=tile[1], near=NEAR, far=FAR)
    got = depth_first_frame(scene["gi"], *scene["port_args"], tile_w=tile[0],
                            tile_h=tile[1], **dict(STATICS, **scene["size"],
                                                   capacity=64 * 4096))
    assert int(got.header.overflow) == 0
    assert int(got.header.visible_count) == aux["visible"]
    assert int(got.header.total_instances) == aux["total_instances"]
    np.testing.assert_allclose(got.color.numpy(), color, atol=COLOR_TOL)
    np.testing.assert_allclose(got.depth.numpy(), depth, atol=DEPTH_TOL)
    assert float(color[..., :3].max()) > 0.05
