"""The mono frames of gsm_renderer_tpu_torch at every tile geometry (on the
CPU: the plain PyTorch versions of the kernels) against the JAX package's
interpret-mode stages and frames.

The JAX package's frame functions take ``tile_w`` and ``tile_h`` unchecked;
the port takes each side in {8, 16, 32} (``kernels.expand.TILE_SIDES``)
and refuses the rest.  On seeded 300-gaussian scenes: a light one at 128x96,
and for the row decomposition a heavy-tailed one at 256x192, whose rects
outgrow the 8x4 window at 32-pixel tiles:

* stages, each fed the JAX stage's own inputs, at 8x8, 16x8 and 32x32, and
  at 32x16 with the row decomposition: the packed projection (rect words,
  rect_h and the depth word equal; record words equal but theta's u16,
  held as tests/test_torch_project.py holds it), prep (offsets, rect words
  and masks), the row table at 32x16, the expand (key1, key2, slot total,
  overflow) and the blend of JAX's sorted table (through the identity key);
* frames: ``depth_first_frame`` at 8x8, 16x8, 8x16 and 32x32, with rows
  (``row_capacity=8192``) at 32x16 and 32x32, the Hardware frame
  (``exact_tile_test=False, depth_mode="normalized", r2_cutoff=9``) at
  32x16, ``local_frame`` at 32x16 and ``global_frame`` at 8x32.

Tolerances (those of tests/test_torch_global_local.py and
tests/test_torch_binning.py):
* integer outputs equal, up to float-boundary flips of the projection or a
  tile test, counted and capped at 0.2% of the gaussians (none on this
  scene so far); theta within +-1 u16, or within THETA_TOL weighted by the
  record's anisotropy;
* blended tiles of the same sorted table: colour and alpha within 1e-5,
  weighted depth within 1e-4 (the same float sequence; exp and log differ
  by an ulp between XLA and PyTorch);
* frames: every header field equal (visible_count, total_instances,
  overflow, slot_total, row_total); colour and alpha max |d| <= 1e-2
  against JAX; weighted depth <= 5e-2; normalized depth <= 5e-2 where
  alpha > 0.05; first-hit depth (Local) equal except at pixels of float
  noise at the 0.1 threshold, capped at 0.5% of the pixels.

JAX's stages and frames are computed once per module (fixtures ``stages``
and ``jax_frames``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.kernels import blend as JK
from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.kernels.project import project_and_cull_packed as jax_project
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines.common import binning_sorted_tile as jax_sorted_tile
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_df
from gsm_renderer_tpu.pipelines.global_ import global_frame as jax_global
from gsm_renderer_tpu.pipelines.local import local_frame as jax_local

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame
from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
from gsm_renderer_tpu_torch.pipelines.local import local_frame

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

W, H, N, NEAR, FAR = 128, 96, 300, 0.1, 20.0
#: the heavy scene's frame
HW, HH = 256, 192
COLOR_TOL, DEPTH_TOL = 1e-2, 5e-2
FLIP_CAP = max(int(0.002 * N), 1)
THETA_TOL = 4.0
ROWS = 8192
PROJ = dict(width=W, height=H, sh_degree=1, near_plane=NEAR, far_plane=FAR,
            alpha_threshold=0.005, total_ink_threshold=2.0,
            input_is_srgb=False)
STATICS = dict(PROJ, capacity=4096)
#: the heavy scene's capacity
HEAVY_CAP = 8 * 4096
#: (tile_w, tile_h, row capacity) of the stage fixtures; rows on the heavy
#: scene
STAGE_TILES = [(8, 8, 0), (16, 8, 0), (32, 32, 0), (32, 16, ROWS)]
#: name -> (JAX frame, port frame, keyword arguments)
FRAMES = {
    "df_8x8": (jax_df, depth_first_frame, dict(tile_w=8, tile_h=8)),
    "df_16x8": (jax_df, depth_first_frame, dict(tile_w=16, tile_h=8)),
    "df_8x16": (jax_df, depth_first_frame, dict(tile_w=8, tile_h=16)),
    "df_32x32": (jax_df, depth_first_frame, dict(tile_w=32, tile_h=32)),
    "rows_32x16": (jax_df, depth_first_frame,
                   dict(tile_w=32, tile_h=16, row_capacity=ROWS,
                        capacity=HEAVY_CAP)),
    "rows_32x32": (jax_df, depth_first_frame,
                   dict(tile_w=32, tile_h=32, row_capacity=ROWS,
                        capacity=HEAVY_CAP)),
    "hardware_32x16": (jax_df, depth_first_frame,
                       dict(tile_w=32, tile_h=16, exact_tile_test=False,
                            depth_mode="normalized", r2_cutoff=9.0)),
    "local_32x16": (jax_local, local_frame, dict(tile_w=32, tile_h=16)),
    "global_8x32": (jax_global, global_frame, dict(tile_w=8, tile_h=32)),
}
HEADER = ("visible_count", "total_instances", "overflow", "slot_total",
          "row_total")


def i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


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


def header(out):
    return {f: (None if getattr(out.header, f) is None
                else int(getattr(out.header, f))) for f in HEADER}


def make_scene(ds, w, h):
    cam = G.make_camera(w, h, far=FAR)
    gi = T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                               ds.opacities, ds.harmonics, device="cpu")
    return dict(ds=ds, jgi=ds.to_input(), jax_args=cam.astuple_jax(), gi=gi,
                port_args=(cam.view_matrix, cam.projection_matrix,
                           cam.position), w=w, h=h,
                size=dict(width=w, height=h))


@pytest.fixture(scope="module")
def scene():
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.06)), W, H)


@pytest.fixture(scope="module")
def heavy():
    """The heavy-tailed scene of tests/test_torch_rows.py, 300 gaussians."""
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.6),
                              seed=13), HW, HH)


def scene_of(name_or_rows, scene, heavy):
    """The heavy scene for the row decomposition, else the light one."""
    return heavy if name_or_rows else scene


@pytest.fixture(scope="module")
def stages(scene, heavy):
    """The JAX Pallas chain (interpret mode) at each STAGE_TILES geometry,
    as numpy: packed projection, prep table, row table, expand, sort,
    ranges and the blend of the sorted table."""
    out = {}
    for tile_w, tile_h, rows in STAGE_TILES:
        sc = scene_of(rows, scene, heavy)
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


@pytest.fixture(scope="module")
def jax_frames(scene, heavy):
    out = {}
    for name, (jfn, _pfn, kw) in FRAMES.items():
        sc = scene_of(name.startswith("rows"), scene, heavy)
        out[name] = jax.tree_util.tree_map(
            np.asarray, jfn(sc["jgi"], *sc["jax_args"], interpret=True,
                            **{**STATICS, **sc["size"], **kw}))
    return out


STAGE_IDS = [f"{w}x{h}" + ("_rows" if r else "") for w, h, r in STAGE_TILES]


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_projection_matches_pallas(scene, heavy, stages, tile):
    ref = stages[tile]
    sc = scene_of(ref["rows"], scene, heavy)
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


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_prep_matches_pallas(stages, tile):
    ref = stages[tile]
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


def test_row_table_matches_pallas(stages):
    """The row decomposition at 32x16 on JAX's count_rows prep table."""
    ref = stages[(32, 16)]
    prep, rows = ref["prep"], ref["row_tab"]
    off2, rect2, mask2, dsw2, words2, ov = TE.row_expand(
        i32(prep[0, :N + 1]), i32(prep[1, :N]), i32(prep[2, :N]),
        i32(prep[3, :N]), [i32(prep[4 + k, :N]) for k in range(4)],
        row_capacity=ROWS, tile_w=32, tile_h=16)
    assert int(ov) == 0
    np.testing.assert_array_equal(off2.numpy(), rows[0, :ROWS + 1])
    for k, got in enumerate([rect2, mask2, dsw2] + words2):
        np.testing.assert_array_equal(u32(got.numpy()), u32(rows[1 + k, :ROWS]),
                                      err_msg=f"plane {1 + k}")
    oversized = (u32(prep[1, :N]) & (TE.MASKED_BIT | TE.CULLED_BIT)) == 0
    assert oversized.any()  # rect rows exercised at 32x16


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_expand_matches_pallas(stages, tile):
    ref = stages[tile]
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


@pytest.mark.parametrize("tile", [(w, h) for w, h, _ in STAGE_TILES],
                         ids=STAGE_IDS)
def test_blend_matches_pallas(stages, tile):
    """The blend of JAX's sorted table, read through the identity key."""
    ref = stages[tile]
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


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, heavy, jax_frames, name):
    _jfn, pfn, kw = FRAMES[name]
    ref = jax_frames[name]
    sc = scene_of(name.startswith("rows"), scene, heavy)
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


def test_rows_frames_bit_equal_to_rows_off(heavy):
    """Rows narrow the slots, not the image, at 32x16 and 32x32 too."""
    for tile_w, tile_h in ((32, 16), (32, 32)):
        kw = dict(STATICS, **heavy["size"], tile_w=tile_w, tile_h=tile_h,
                  capacity=HEAVY_CAP)
        on = depth_first_frame(heavy["gi"], *heavy["port_args"],
                               row_capacity=ROWS, **kw)
        off = depth_first_frame(heavy["gi"], *heavy["port_args"], **kw)
        assert torch.equal(on.color, off.color)
        assert torch.equal(on.depth, off.depth)
        assert int(on.header.slot_total) < int(off.header.slot_total)
