"""Foveated stereo parity: gsm_renderer_tpu_torch's foveated host tables,
the bounds gather (kernel 7), the foveated re-binning, prep and expand in
mode "warped", the blend with ``pixel_coords`` and
``render_stereo_foveated`` against the JAX package (Pallas in interpret
mode), twinning tests/test_foveated.py.

Tolerances:
* host tables: ``make_rate_maps``, ``warp_tables`` and
  ``foveated_raster_tables`` bit-equal to JAX for two targets;
  ``expand_foveated`` / ``compress_foveated`` within 1e-6 (XLA:CPU may
  contract the bilinear weights' multiply-adds).
* bounds gather: the plain version bit-equal to
  ``warped_bounds_gather_pallas(interpret=True)`` and to
  ``bounds[axis][min(t + d, 127)]``, and to the one-hot oracle wherever the
  window stays inside the row (the oracle wraps past 127); indices up to
  and past the clamp at 127 included.
* re-binning (``foveated_rects`` on the JAX projection's pixel bounds):
  min_tx / max_tx / min_ty / max_ty equal to JAX's except counted floor
  flips, each within 1e-3 tile of an integer in the float64 polynomial
  (XLA:CPU may contract the Horner steps into FMAs; the port rounds each
  step, as the card does), at most 1% of the gaussians.
* prep "warped" fed the JAX stage's own inputs, ``lod_min`` 0 and 5:
  offsets, rect words and masks equal up to counted mask flips (<= 0.2%,
  as the stereo test allows).
* expand "warped" fed the JAX prep table: keys equal, and the 8 words JAX
  carries equal to the entry words at each live slot's index.  A
  table whose MASKED entries carry their whole window keeps exactly the
  slots of the exact-mask table: the expand re-tests MASKED entries under
  the warp (a bypass would keep the extra slots).
* blend with ``pixel_coords`` (plain, ``n_eyes=2, r2_cutoff=9``) against
  ``blend_tiles_pallas(..., pixel_coords=..., n_eyes=2, r2_cutoff=9.0,
  interpret=True)`` on the same sorted table (the port reads it through the
  identity key): max |d| <= 1e-5 in both eyes.
* the frame vs JAX ``depth_first_stereo_foveated_frame(interpret=True)``:
  colour <= 1e-2, depth <= 5e-2, equal visible_count / total_instances, and
  slot_total equal up to 32 slots per gaussian whose prep output differs
  between the two chains.
* ``render_stereo_foveated``: the bounds of tests/test_foveated.py
  (expanded to the display it is at least as faithful to a full-resolution
  stereo frame as the render-then-compress path, mean |d| < 0.05), and
  ``foveated_lod=5`` prunes slots while the fovea crop stays bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
import gsm_renderer_tpu.pipelines.depth_first as JD
from gsm_renderer_tpu import stereo as JS
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.kernels import blend as JK
from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines.common import binning_sorted_tile as jax_sorted_tile

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import stereo as TS
from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels.project import StereoPackedProjection
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import depth_first as TD
from test_torch_binning import assert_words_at_entries

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

NEAR, FAR = 0.1, 20.0
W, H, N = 128, 96, 300
STATICS = dict(tile_w=16, tile_h=16, near_plane=NEAR, far_plane=FAR,
               alpha_threshold=0.005, total_ink_threshold=2.0,
               input_is_srgb=False)


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).view(np.int32).copy())


def f32(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def ds_to_torch(ds):
    return T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                                 ds.opacities, ds.harmonics, device="cpu")


def rig(w, h, ipd=0.15):
    cam = G.make_camera(w, h, far=FAR)
    js = G.make_side_by_side_stereo(cam, ipd=ipd)
    views = np.stack([js.left.view_matrix, js.right.view_matrix]).astype(np.float32)
    projs = np.stack([js.left.projection_matrix,
                      js.right.projection_matrix]).astype(np.float32)
    centers = np.stack([js.left.position, js.right.position]).astype(np.float32)
    ts = T.stereo_camera_from_numpy(views, projs, centers, NEAR, FAR, w, h)
    return js, ts, views, projs, centers


TARGETS = [dict(width=128, height=96, min_rate=0.4, radius=0.3),
           dict(width=1920, height=1080, min_rate=0.15, radius=0.3,
                center=(0.45, 0.55))]


@pytest.mark.parametrize("spec", TARGETS, ids=["128x96", "1080p_r15"])
def test_host_tables_match_jax(spec):
    kw = {k: v for k, v in spec.items() if k not in ("width", "height")}
    jt = JS.make_rate_maps(spec["width"], spec["height"], **kw)
    tt = TS.make_rate_maps(spec["width"], spec["height"], **kw)
    np.testing.assert_array_equal(tt.rate_x, jt.rate_x)
    np.testing.assert_array_equal(tt.rate_y, jt.rate_y)
    assert (tt.render_width, tt.render_height) == (jt.render_width,
                                                   jt.render_height)
    for a, b in zip(TS.warp_tables(tt), JS.warp_tables(jt)):
        np.testing.assert_array_equal(a, b)
    ref, got = JS.foveated_raster_tables(jt), TS.foveated_raster_tables(tt)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_expand_and_compress_foveated_match_jax():
    t = TS.make_rate_maps(96, 64, min_rate=0.3, radius=0.25)
    jt = JS.make_rate_maps(96, 64, min_rate=0.3, radius=0.25)
    rng = np.random.default_rng(5)
    inter = rng.random((t.render_height, 2 * t.render_width, 4), np.float32)
    full = rng.random((64, 192, 4), np.float32)
    np.testing.assert_allclose(
        TS.expand_foveated(f32(inter), t).numpy(),
        np.asarray(JS.expand_foveated(jnp.asarray(inter), jt)), atol=1e-6)
    np.testing.assert_allclose(
        TS.compress_foveated(f32(full), t).numpy(),
        np.asarray(JS.compress_foveated(jnp.asarray(full), jt)), atol=1e-6)
    # mono layout and a single channel
    np.testing.assert_allclose(
        TS.expand_foveated(f32(inter[:, :t.render_width, :1]), t,
                           stereo=False).numpy(),
        np.asarray(JS.expand_foveated(jnp.asarray(inter[:, :t.render_width, :1]),
                                      jt, stereo=False)), atol=1e-6)


class _Captured(Exception):
    pass


def _jax_rebinned(ds, views, projs, centers, tabs, plan, tiles_x, tiles_y):
    """JAX's own foveated projection and re-binning, jitted as in the frame:
    ``_foveated_packed_ops`` runs up to its binning call, whose packed
    (re-binned) input is returned instead."""
    def packed_only(*args, packed=None, **kw):
        raise _Captured(packed)

    def run(gi, views, projs, centers, inv_fit, bounds):
        try:
            JD._foveated_packed_ops(
                gi, views, projs, centers, jnp.eye(4, dtype=jnp.float32),
                inv_fit, bounds, None, None, plan, display_width=W,
                display_height=H, capacity=4096, tiles_x=tiles_x,
                tiles_y=tiles_y, sh_degree=1, foveated_lod=0.0,
                interpret=True, **STATICS)
        except _Captured as e:
            p = e.args[0]
            return dict(rect_word=p.rect_word, rect_h=p.rect_h, dsw=p.dsw,
                        words=p.words, visible=p.visible)
        raise AssertionError("the foveated ops did not reach binning")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "binning_sort_operands", packed_only)
        out = jax.jit(run)(ds.to_input(), jnp.asarray(views), jnp.asarray(projs),
                           jnp.asarray(centers), jnp.asarray(tabs["inv_fit"]),
                           jnp.asarray(tabs["bounds"]))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def fov_chain():
    """The JAX foveated chain (interpret mode) on one 128x96 scene: packed
    projection, re-binning, warped prep (lod 0 and 5), warped expand, sort
    and ranges."""
    ds = jax_gen(N, sh_degree=1, seed=9, scale_range=(0.01, 0.08))
    _js, ts, views, projs, centers = rig(W, H)
    jt = JS.make_rate_maps(W, H, min_rate=0.4, radius=0.3)
    tabs = JS.foveated_raster_tables(jt)
    tiles_x, tiles_y = -(-jt.render_width // 16), -(-jt.render_height // 16)
    plan = JB.make_key_plan(tiles_x * tiles_y, N, near_plane=NEAR,
                            far_plane=FAR)
    import gsm_renderer_tpu.kernels.project as JP
    pp = JP.stereo_project_and_cull_packed(
        ds.to_input(), jnp.asarray(views), jnp.asarray(projs),
        jnp.asarray(centers), jnp.eye(4, dtype=jnp.float32), width=W,
        height=H, sh_degree=1, key_plan=plan, interpret=True, **STATICS)
    packed = _jax_rebinned(ds, views, projs, centers, tabs, plan, tiles_x,
                           tiles_y)
    bounds = jnp.asarray(tabs["bounds"])
    tab = {}
    for lod in (0.0, 5.0):
        tab[lod] = JE.binning_prep_pallas(
            jnp.asarray(packed["rect_word"]), jnp.asarray(packed["rect_h"]),
            jnp.asarray(packed["dsw"]), [jnp.asarray(w) for w in packed["words"]],
            mode="warped", warped_bounds=bounds, lod_min=lod, interpret=True)
    flat = np.asarray(tab[0.0]).reshape(tab[0.0].shape[0], -1)
    cap = (int(flat[0, N]) // 4096 + 1) * 4096
    outs = JE.expand_slots_pallas(None, None, None, capacity=cap,
                                  tiles_x=tiles_x, exact_test="stereo",
                                  prebuilt_tab=tab[0.0], n_gaussians=N,
                                  warped_bounds=bounds,
                                  key_plan=plan.kernel_tuple, interpret=True)
    srt = jax.lax.sort(tuple(outs[:10]), num_keys=2, is_stable=False)
    sorted_tile = jax_sorted_tile(srt[0], fused_depth16=False,
                                  plan_tuple=plan.kernel_tuple)
    starts, counts = JB.extract_tile_ranges(sorted_tile, tiles_x * tiles_y)
    preps = {}
    for lod, t in tab.items():
        fl = np.asarray(t).reshape(t.shape[0], -1)
        preps[lod] = dict(offsets=fl[0, :N + 1], rect=fl[1, :N], mask=fl[2, :N])
    return dict(
        ds=ds, ts=ts, views=views, projs=projs, centers=centers, tabs=tabs,
        target=TS.make_rate_maps(W, H, min_rate=0.4, radius=0.3),
        tiles_x=tiles_x, tiles_y=tiles_y, cap=cap, plan=plan,
        pixel_bounds={k: np.asarray(getattr(pp, k))
                      for k in ("px_min", "px_max", "py_min", "py_max")},
        proj_visible=np.asarray(pp.visible), packed=packed, preps=preps,
        dsw=flat[3, :N], words=[flat[4 + k, :N] for k in range(8)],
        expand=[np.asarray(o) for o in outs],
        sorted_words=[np.asarray(o) for o in srt[2:]],
        starts=np.asarray(starts), counts=np.asarray(counts))


def test_bounds_gather_matches_pallas(fov_chain):
    c = fov_chain
    rw = u32(c["packed"]["rect_word"])
    # the frame's window corners, then corners that run into the clamp
    edge = np.arange(112, 136, dtype=np.int32)
    min_tx = np.concatenate([(rw & 0x3FF).astype(np.int32), edge])
    min_ty = np.concatenate([((rw >> 10) & 0x3FF).astype(np.int32), edge[::-1]])
    bounds = c["tabs"]["bounds"]
    fx, fy = TE.warped_bounds_gather(f32(bounds), i32(min_tx), i32(min_ty))
    pfx, pfy = JE.warped_bounds_gather_pallas(
        jnp.asarray(bounds), jnp.asarray(min_tx), jnp.asarray(min_ty),
        interpret=True)
    for axis, mins, got, ref in ((0, min_tx, fx, pfx), (1, min_ty, fy, pfy)):
        span = len(got)
        oracle = np.asarray(JE.warped_bounds_gather(
            jnp.asarray(bounds[axis]), jnp.asarray(mins), span))
        inside = mins + span - 1 < 128
        for d in range(span):
            want = bounds[axis][np.minimum(mins + d, 127)]
            np.testing.assert_array_equal(got[d].numpy(), want)
            np.testing.assert_array_equal(got[d].numpy(), np.asarray(ref[d]))
            np.testing.assert_array_equal(got[d].numpy()[inside],
                                          oracle[inside, d])
    assert (min_tx + 8 > 127).any() and (min_ty + 4 > 127).any()
    # the gather reproduces the warped prep's mask through the plain masks
    p, words = c["packed"], [np.asarray(w) for w in c["packed"]["words"]]
    n = rw.shape[0]
    mask, _ = TE.stereo_warped_tile_masks(
        [torch.from_numpy(u32(words[k])) for k in range(3)],
        [torch.from_numpy(u32(words[k])) for k in range(4, 7)],
        torch.from_numpy((rw >> 20) & 0x3FF),
        torch.from_numpy(np.asarray(p["rect_h"]).astype(np.int64)),
        [x[:n] for x in fx], [y[:n] for y in fy])
    np.testing.assert_array_equal(mask.numpy(), u32(c["preps"][0.0]["mask"]))


def _port_rects(c):
    pb = c["pixel_bounds"]
    pp = StereoPackedProjection(
        rect_word=None, rect_h=None, dsw=None, words=None,
        visible=torch.from_numpy(c["proj_visible"].copy()),
        **{k: f32(v) for k, v in pb.items()})
    return TD.foveated_rects(pp, c["tabs"]["inv_fit"], tiles_x=c["tiles_x"],
                             tiles_y=c["tiles_y"])


def test_rebinning_matches_jax(fov_chain):
    c = fov_chain
    (min_tx, max_tx, min_ty, max_ty), visible, rect_count = _port_rects(c)
    rw = u32(c["packed"]["rect_word"])
    ref_min_tx, ref_min_ty = rw & 0x3FF, (rw >> 10) & 0x3FF
    ref_rect_w = (rw >> 20) & 0x3FF
    ref_vis = np.asarray(c["packed"]["visible"])
    ref_h = np.asarray(c["packed"]["rect_h"])
    vis = visible.numpy()
    assert vis.sum() > N // 2
    fit = c["tabs"]["inv_fit"].astype(np.float64)
    flips = 0
    for name, got, ref, axis, key, sign in (
            ("min_tx", min_tx, ref_min_tx, 0, "px_min", -1),
            ("max_tx", max_tx, ref_min_tx + ref_rect_w - 1, 0, "px_max", 1),
            ("min_ty", min_ty, ref_min_ty, 1, "py_min", -1),
            ("max_ty", max_ty, ref_min_ty + np.maximum(ref_h, 1) - 1, 1,
             "py_max", 1)):
        got = got.numpy().astype(np.int64)
        diff = (got != ref) & ref_vis
        flips += int(diff.sum())
        if diff.any():
            v = c["pixel_bounds"][key].astype(np.float64)[diff]
            row = fit[axis]
            s = np.polyval(row[:10], v / row[11] * 2.0 - 1.0) + sign * row[12]
            frac = s / 16.0 - np.round(s / 16.0)
            assert np.abs(frac).max() <= 1e-3, (name, frac)
            assert np.abs(got[diff] - ref[diff]).max() <= 1, name
    assert flips <= max(1, N // 100), flips
    np.testing.assert_array_equal(vis, ref_vis)
    if flips == 0:
        np.testing.assert_array_equal(rect_count.numpy()[vis],
                                      (ref_rect_w * ref_h)[vis])


@pytest.mark.parametrize("lod_min", [0.0, 5.0])
def test_warped_prep_matches_pallas(fov_chain, lod_min):
    c = fov_chain
    p, ref = c["packed"], c["preps"][lod_min]
    offsets, rect, mask = TE.binning_prep(
        i32(p["rect_word"]), i32(p["rect_h"]), [i32(x) for x in p["words"]],
        mode="warped", warped_bounds=f32(c["tabs"]["bounds"]), lod_min=lod_min)
    flips = u32(mask.numpy()) != u32(ref["mask"])
    assert flips.sum() <= int(0.002 * N)
    same = ~flips
    np.testing.assert_array_equal(np.diff(offsets.numpy().astype(np.int64))[same],
                                  np.diff(ref["offsets"].astype(np.int64))[same])
    np.testing.assert_array_equal(u32(rect.numpy())[same], u32(ref["rect"])[same])
    if not flips.any():
        np.testing.assert_array_equal(offsets.numpy(), ref["offsets"])
    assert ((u32(rect.numpy()) & TE.MASKED_BIT) != 0).sum() > N // 4
    if lod_min > 0.0:
        # the LOD dropped some periphery instances
        assert int(offsets[N]) < int(c["preps"][0.0]["offsets"][N])


def _expand(c, offsets, rect, mask):
    return TE.expand_slots(
        i32(offsets), i32(rect), i32(mask), i32(c["dsw"]),
        [i32(x) for x in c["words"]], capacity=c["cap"],
        tiles_x=c["tiles_x"], mode="warped",
        warped_bounds=f32(c["tabs"]["bounds"]),
        key_plan=TB.make_key_plan(c["tiles_x"] * c["tiles_y"], N,
                                  near_plane=NEAR, far_plane=FAR))


def test_warped_expand_matches_pallas(fov_chain):
    c = fov_chain
    prep = c["preps"][0.0]
    key1, key2, total, overflow = _expand(c, prep["offsets"], prep["rect"],
                                          prep["mask"])
    ref = c["expand"]
    for k, g in enumerate([key1, key2]):
        np.testing.assert_array_equal(u32(g.numpy()), u32(ref[k]),
                                      err_msg=f"output {k}")
    assert_words_at_entries(key1, key2, c["plan"].idx_bits, c["words"],
                            ref[2:10])
    assert int(total) == int(ref[10]) and int(overflow) == int(ref[11]) == 0


def test_warped_expand_retests_masked_entries(fov_chain):
    """MASKED entries widened to their whole rect window: the re-test under
    the warp keeps exactly the slots the exact masks keep (a bypass of the
    test for MASKED entries would keep every widened slot)."""
    c = fov_chain
    prep = c["preps"][0.0]
    rect = u32(prep["rect"])
    masked = ((rect & TE.MASKED_BIT) != 0) & ((rect & TE.CULLED_BIT) == 0)
    rect_w = (rect >> 20) & 0x3FF
    rect_h = np.asarray(c["packed"]["rect_h"]).astype(np.int64)
    full = np.zeros(N, np.int64)
    for dy in range(TE.MASK_H):
        for dx in range(TE.MASK_W):
            full |= ((dx < rect_w) & (dy < rect_h)).astype(np.int64) << (dy * 8 + dx)
    wide = np.where(masked, full, u32(prep["mask"]))
    counts = np.diff(prep["offsets"].astype(np.int64))
    counts = np.where(masked, [bin(int(m)).count("1") for m in wide], counts)
    wide_off = np.concatenate([[0], np.cumsum(counts)])
    assert wide_off[N] > prep["offsets"][N]          # the widening added slots

    def live(out):
        k1, k2 = u32(out[0].numpy()), u32(out[1].numpy())
        keep = k1 != TE.SENTINEL
        return sorted(zip(k1[keep], k2[keep]))

    exact = _expand(c, prep["offsets"], prep["rect"], prep["mask"])
    widened = _expand(c, wide_off.astype(np.int32), prep["rect"],
                      wide.astype(np.uint32))
    assert live(widened) == live(exact)


def test_pixel_coords_blend_matches_pallas(fov_chain):
    c = fov_chain
    table = torch.stack([i32(x) for x in c["sorted_words"]])
    starts, counts = i32(c["starts"]), i32(c["counts"])
    coords = (c["tabs"]["coord_x"], c["tabs"]["coord_y"])
    ref = JK.blend_tiles_pallas(
        JK.build_words_table([jnp.asarray(x) for x in c["sorted_words"]],
                             c["cap"]),
        jnp.asarray(c["starts"]), jnp.asarray(c["counts"]),
        tiles_x=c["tiles_x"], tiles_y=c["tiles_y"], n_eyes=2, r2_cutoff=9.0,
        pixel_coords=tuple(jnp.asarray(x) for x in coords), interpret=True)
    identity = torch.arange(c["cap"], dtype=torch.int64)
    got = TK.blend_tiles_plain(identity, table, 32, starts, counts,
                               tiles_x=c["tiles_x"], n_eyes=2, r2_cutoff=9.0,
                               pixel_coords=tuple(f32(x) for x in coords))
    for (rc, rd), (gc, gd) in zip(ref, got):
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-5)
    assert float(got[0][0][..., :3].max()) > 0.05
    assert float(got[1][0][..., :3].max()) > 0.05
    # the warped coordinates are not the uniform grid's
    uniform = TK.blend_tiles_plain(identity, table, 32, starts, counts,
                                   tiles_x=c["tiles_x"], n_eyes=2, r2_cutoff=9.0)
    assert float((uniform[0][0] - got[0][0]).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def jax_frame(fov_chain):
    c = fov_chain
    t = JS.make_rate_maps(W, H, min_rate=0.4, radius=0.3)
    tabs = c["tabs"]
    frame = functools.partial(
        JD.depth_first_stereo_foveated_frame, display_width=W,
        display_height=H, render_width=t.render_width,
        render_height=t.render_height, capacity=8 * 4096, sh_degree=1,
        interpret=True, **STATICS)
    out = jax.jit(frame)(
        c["ds"].to_input(), jnp.asarray(c["views"]), jnp.asarray(c["projs"]),
        jnp.asarray(c["centers"]), jnp.eye(4, dtype=jnp.float32),
        jnp.asarray(tabs["inv_fit"]), jnp.asarray(tabs["coord_x"]),
        jnp.asarray(tabs["coord_y"]), jnp.asarray(tabs["bounds"]))
    return jax.tree_util.tree_map(np.asarray, out)


def test_foveated_frame_matches_jax(fov_chain, jax_frame):
    c, ref = fov_chain, jax_frame
    t = c["target"]
    kw = dict(display_width=W, display_height=H, render_width=t.render_width,
              render_height=t.render_height, capacity=8 * 4096, sh_degree=1,
              **STATICS)
    tables = TD.foveated_device_tables(t, "cpu")
    gi = ds_to_torch(c["ds"])
    got = TD.depth_first_stereo_foveated_frame(
        gi, c["views"], c["projs"], c["centers"], np.eye(4, dtype=np.float32),
        tables, **kw)
    assert got.color.shape == (t.render_height, 2 * t.render_width, 4)
    assert got.depth.shape == (t.render_height, 2 * t.render_width)
    for f in ("visible_count", "total_instances", "overflow"):
        assert int(getattr(got.header, f)) == int(getattr(ref.header, f)), f
    # slot totals: equal up to the gaussians whose prep output differs
    # between the port's chain and JAX's
    pp = TD.stereo_project_and_cull_packed(
        gi, c["views"], c["projs"], c["centers"], np.eye(4, dtype=np.float32),
        width=W, height=H, sh_degree=1, key_plan=TB.make_key_plan(
            c["tiles_x"] * c["tiles_y"], N, near_plane=NEAR, far_plane=FAR),
        **STATICS)
    warped, _ = TD.foveated_packed(pp, tables["inv_fit"], tiles_x=c["tiles_x"],
                                   tiles_y=c["tiles_y"])
    offsets, rect, mask = TE.binning_prep(
        warped.rect_word, warped.rect_h, warped.words, mode="warped",
        warped_bounds=tables["bounds"])
    ref_prep = c["preps"][0.0]
    differ = ((u32(mask.numpy()) != u32(ref_prep["mask"]))
              | (u32(rect.numpy()) != u32(ref_prep["rect"])))
    slot_diff = abs(int(got.header.slot_total) - int(ref.header.slot_total))
    assert slot_diff <= 32 * int(differ.sum()), (slot_diff, int(differ.sum()))
    np.testing.assert_allclose(got.color.numpy(), ref.color, atol=1e-2)
    np.testing.assert_allclose(got.depth.numpy(), ref.depth, atol=5e-2)
    w = t.render_width
    assert float(got.color[:, :w, :3].max()) > 0.05
    assert float(got.color[:, w:, :3].max()) > 0.05


def _scene_and_stereo(w, h, n, seed=2):
    ds = jax_gen(n, sh_degree=1, seed=seed, scale_range=(0.01, 0.06))
    cam = T.make_camera(w, h)
    return ds_to_torch(ds), T.make_side_by_side_stereo(cam, ipd=0.1)


def test_render_stereo_foveated_contract():
    w, h = 128, 96
    gi, stereo = _scene_and_stereo(w, h, 220)
    t = T.make_rate_maps(w, h, min_rate=0.4, radius=0.3)
    r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1), device="cpu")
    o1 = r.render_stereo_foveated(gi, stereo, t)
    out = r.render_stereo_foveated(gi, stereo, t)      # locked-in capacity
    np.testing.assert_array_equal(o1.color.numpy(), out.color.numpy())
    phys = out.color.numpy()
    assert phys.shape == (t.render_height, 2 * t.render_width, 4)
    assert np.isfinite(phys).all() and np.isfinite(out.depth.numpy()).all()
    assert phys[:, :t.render_width, :3].max() > 0.05
    assert phys[:, t.render_width:, :3].max() > 0.05
    assert int(out.header.overflow) == 0
    disp = T.expand_foveated(out.color, t).numpy()
    full = r.render_stereo(gi, stereo, w, h).color.numpy()
    assert disp.shape == full.shape
    comp = r.render_stereo_foveated_compress(gi, stereo, t)
    assert comp.color.shape == out.color.shape
    disp_c = T.expand_foveated(comp.color, t).numpy()
    err_direct = np.abs(disp[..., :3] - full[..., :3]).mean()
    err_compress = np.abs(disp_c[..., :3] - full[..., :3]).mean()
    assert err_direct < max(1.3 * err_compress, 0.01), (err_direct, err_compress)
    assert err_direct < 0.05


def test_foveated_periphery_lod():
    w, h = 128, 96
    gi, stereo = _scene_and_stereo(w, h, 300)
    t = T.make_rate_maps(w, h, min_rate=0.35, radius=0.2)
    out0 = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1), device="cpu"
                                ).render_stereo_foveated(gi, stereo, t)
    out1 = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1, foveated_lod=5.0),
                                device="cpu").render_stereo_foveated(gi, stereo, t)
    assert int(out1.header.slot_total) < int(out0.header.slot_total)
    c0, c1 = out0.color.numpy(), out1.color.numpy()
    assert np.isfinite(c1).all()
    cy = t.render_height // 2
    cx = int(np.floor(t.rate_x[: w // 2].sum()))
    for e in range(2):
        sl = (slice(cy - 4, cy + 4),
              slice(e * t.render_width + cx - 4, e * t.render_width + cx + 4))
        np.testing.assert_array_equal(c1[sl], c0[sl])
    assert np.abs(c1[..., :3] - c0[..., :3]).mean() < 0.02
