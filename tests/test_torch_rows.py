"""Row decomposition parity: the per-row exact-span expansion of oversized
rects in gsm_renderer_tpu_torch (prep ``count_rows``, ``row_expand``, the
rows-on frame, ``pick_row_capacity``) against the JAX package, twinning
tests/test_row_expand.py at its sizes (256x192, ``scale_range=(0.01,
0.6)``), plus the realistic scene generator.

Tolerances:
* prep ``count_rows``: offsets equal (row counts do not read the mask); the
  8x4 masks, and with them the CULLED bit of a mask that empties, may
  differ by float-boundary flips (cos/sin/log differ by an ulp between XLA
  and PyTorch), counted and capped at 0.2% of the gaussians.
* ``row_expand_plain`` vs ``row_expand_pallas(interpret=True)`` on the JAX
  prep table: the mask, depth and record planes equal exactly; a row's rect
  word and count may flip only at a span boundary (the span's lo or hi end
  moves by one tile, same tile row), counted and capped at 0.2% of the rows.
* the rows-on frame is bit-equal to the rows-off frame of the port, with a
  smaller ``slot_total`` and equal ``total_instances``.
* the rows-on frame vs JAX ``depth_first_frame(row_capacity=...)`` in
  interpret mode: colour and alpha max |d| <= 1e-2, depth <= 5e-2, counters
  equal except ``slot_total``, which a span-boundary flip moves by one dead
  slot (at most 0.2% of the rows).
* ``generate_realistic_gaussians``: arrays equal to the JAX package's (whose
  Morton sort runs in its native helper's float32 arithmetic).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu.io.scene import generate_realistic_gaussians as jax_realistic
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.kernels.project import project_and_cull_packed as jax_project
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_frame

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.io.scene import (generate_realistic_gaussians,
                                             generate_visible_gaussians)
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import depth_first as TD

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

W, H = 256, 192
TILES_X, TILES_Y = W // 16, H // 16
NEAR, FAR = 0.1, 20.0
STATICS = dict(width=W, height=H, sh_degree=1, alpha_threshold=0.005,
               total_ink_threshold=2.0, near_plane=NEAR, far_plane=FAR,
               input_is_srgb=False)


def i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def heavy(n, seed):
    """The heavy-tailed scene of tests/test_row_expand.py (numpy, shared
    by both packages)."""
    return jax_gen(n, sh_degree=1, scale_range=(0.01, 0.6), seed=seed)


@pytest.fixture(scope="module")
def chain():
    """JAX packed projection and count_rows prep table (interpret mode) on
    the 1500-gaussian heavy scene, as numpy."""
    n = 1500
    ds = heavy(n, 13)
    cam = G.make_camera(W, H, far=FAR)
    view, proj, center = cam.astuple_jax()
    plan = JB.make_key_plan(TILES_X * TILES_Y, n, near_plane=NEAR, far_plane=FAR)
    packed = jax_project(ds.to_input(), view, proj, center, tile_w=16,
                         tile_h=16, key_plan=plan, interpret=True,
                         **{k: v for k, v in STATICS.items()})
    tab = JE.binning_prep_pallas(packed.rect_word, packed.rect_h, packed.dsw,
                                 packed.words, interpret=True, count_rows=True)
    flat = np.asarray(tab).reshape(tab.shape[0], -1)
    return dict(n=n, tab=tab, packed=packed,
                rect_word=np.asarray(packed.rect_word),
                rect_h=np.asarray(packed.rect_h),
                words=[np.asarray(w) for w in packed.words],
                offsets=flat[0, :n + 1], rect=flat[1, :n], mask=flat[2, :n],
                dsw=flat[3, :n], twords=[flat[4 + k, :n] for k in range(4)])


def test_prep_count_rows_matches_pallas(chain):
    n = chain["n"]
    offsets, rect, mask, _sums = TE.binning_prep(
        i32(chain["rect_word"]), i32(chain["rect_h"]),
        [i32(w) for w in chain["words"]], count_rows=True)
    np.testing.assert_array_equal(offsets.numpy(), chain["offsets"])
    flips = u32(mask.numpy()) != u32(chain["mask"])
    assert flips.sum() <= int(0.002 * n), f"{flips.sum()} mask flips"
    rect_diff = u32(rect.numpy()) != u32(chain["rect"])
    assert not (rect_diff & ~flips).any()  # the CULLED bit moves only with a flip
    rows = np.diff(offsets.numpy().astype(np.int64))
    oversized = (u32(rect.numpy()) & (TE.MASKED_BIT | TE.CULLED_BIT)) == 0
    np.testing.assert_array_equal(rows[oversized], chain["rect_h"][oversized])
    assert (rows[~oversized] == 1).all()
    assert oversized.sum() > 100  # the scene exercises the row path


@pytest.mark.parametrize("r_cap", [32768, 2048])
def test_row_expand_matches_pallas(chain, r_cap):
    """Plain row expansion on the JAX count_rows table vs the interpret-mode
    Pallas kernel; r_cap 2048 drops rows past the capacity (row_overflow)."""
    n = chain["n"]
    ref, ref_ov = JE.row_expand_pallas(chain["tab"], n=n, row_capacity=r_cap,
                                       interpret=True)
    ref = np.asarray(ref).reshape(ref.shape[0], -1)
    off2, rect2, mask2, dsw2, words2, ov = TE.row_expand(
        i32(chain["offsets"]), i32(chain["rect"]), i32(chain["mask"]),
        i32(chain["dsw"]), [i32(w) for w in chain["twords"]],
        row_capacity=r_cap)
    assert int(ov) == int(ref_ov) == int(int(chain["offsets"][n]) > r_cap)
    for k, got in enumerate([mask2, dsw2] + words2):
        np.testing.assert_array_equal(u32(got.numpy()), u32(ref[2 + k, :r_cap]),
                                      err_msg=f"plane {2 + k}")
    r_ref, r_got = u32(ref[1, :r_cap]), u32(rect2.numpy())
    flips = np.nonzero(r_ref != r_got)[0]
    assert len(flips) <= int(0.002 * r_cap), f"{len(flips)} rect flips"
    for r in flips:  # only at a span boundary
        lo_a, ty_a, w_a = r_ref[r] & 0x3FF, (r_ref[r] >> 10) & 0x3FF, (r_ref[r] >> 20) & 0x3FF
        lo_b, ty_b, w_b = r_got[r] & 0x3FF, (r_got[r] >> 10) & 0x3FF, (r_got[r] >> 20) & 0x3FF
        assert ty_a == ty_b and abs(int(lo_a) - int(lo_b)) <= 1
        assert abs(int(lo_a + w_a) - int(lo_b + w_b)) <= 1
    counts_ref = np.diff(ref[0, :r_cap + 1].astype(np.int64))
    counts_got = np.diff(off2.numpy().astype(np.int64))
    same = r_ref == r_got
    np.testing.assert_array_equal(counts_got[same], counts_ref[same])
    assert (counts_got[~same] - counts_ref[~same] != 0).sum() <= len(flips)
    if not len(flips):
        np.testing.assert_array_equal(off2.numpy(), ref[0, :r_cap + 1])


def ds_to_torch(ds):
    return T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                                 ds.opacities, ds.harmonics, device="cpu")


def test_row_span_superset_of_exact_test():
    """Every tile passing the expand's exact test lies inside its row's
    span (the span may only add boundary tiles), on the port's own prep."""
    n = 600
    ds = heavy(n, 29)
    cam = T.make_camera(W, H, far=FAR)
    plan = TB.make_key_plan(TILES_X * TILES_Y, n, near_plane=NEAR, far_plane=FAR)
    packed = TP.project_and_cull_packed(
        ds_to_torch(ds), cam.view_matrix, cam.projection_matrix, cam.position,
        tile_w=16, tile_h=16, key_plan=plan, **STATICS)
    offsets, rect, mask, _sums = TE.binning_prep(
        packed.rect_word, packed.rect_h, packed.words, count_rows=True)
    rw = u32(rect.numpy())
    off = offsets.numpy().astype(np.int64)
    words = [u32(w.numpy()) for w in packed.words]
    gs, txs, tys = [], [], []
    for g in np.nonzero((rw & (TE.CULLED_BIT | TE.MASKED_BIT)) == 0)[0]:
        min_tx, min_ty, rect_w = rw[g] & 0x3FF, (rw[g] >> 10) & 0x3FF, (rw[g] >> 20) & 0x3FF
        for dy in range(int(off[g + 1] - off[g])):
            for tx in range(min_tx, min_tx + rect_w):
                gs.append(g)
                txs.append(tx)
                tys.append(min_ty + dy)
    assert len(gs) > 200
    gs, txs, tys = (torch.tensor(np.asarray(v), dtype=torch.int64)
                    for v in (gs, txs, tys))
    w = [torch.from_numpy(x)[gs] for x in words]
    rw_t = torch.from_numpy(rw)[gs]
    t_lo, span = TE.row_tile_span(w[0], w[1], w[2], w[3], tys, rw_t & 0x3FF,
                                  (rw_t >> 20) & 0x3FF, 16.0, 16.0, 0.005)
    passes = TE._exact_tile_test(w[0], w[1], w[2], w[3], txs, tys, 16.0, 16.0,
                                 0.005)
    in_span = (t_lo <= txs) & (txs < t_lo + span)
    assert passes.sum() > 50
    assert not (passes & ~in_span).any()


def port_frame(ds, row_capacity, capacity):
    cam = T.make_camera(W, H, far=FAR)
    return TD.depth_first_frame(
        ds_to_torch(ds), cam.view_matrix, cam.projection_matrix, cam.position,
        capacity=capacity, row_capacity=row_capacity, **STATICS)


def test_rows_frame_bit_equal_to_rows_off():
    """The port's rows-on frame equals its rows-off frame bit for bit, with
    a smaller slot volume; R = 8192 > N = 600 widens the KeyPlan's index
    field to address rows."""
    ds = heavy(600, 17)
    base = port_frame(ds, 0, 4096 * 24)
    rows = port_frame(ds, 8192, 4096 * 24)
    assert TD.d32_key_plan(600, width=W, height=H, tile_w=16, tile_h=16,
                                near_plane=NEAR, far_plane=FAR,
                                row_capacity=8192).idx_bits == 13
    assert int(base.header.overflow) == int(rows.header.overflow) == 0
    np.testing.assert_array_equal(base.color.numpy(), rows.color.numpy())
    np.testing.assert_array_equal(base.depth.numpy(), rows.depth.numpy())
    assert int(rows.header.slot_total) < int(base.header.slot_total)
    assert int(rows.header.total_instances) == int(base.header.total_instances)
    assert int(rows.header.row_total) == int(base.header.row_total)


def test_rows_frame_matches_jax():
    n = 600
    ds = heavy(n, 17)
    cam = G.make_camera(W, H, far=FAR)
    view, proj, center = cam.astuple_jax()
    ref = jax_frame(ds.to_input(), view, proj, center, capacity=4096 * 24,
                    row_capacity=8192, use_xla_blend=False, interpret=True,
                    **STATICS)
    got = port_frame(ds, 8192, 4096 * 24)
    for f in ("visible_count", "total_instances", "overflow", "row_total"):
        assert int(getattr(got.header, f)) == int(getattr(ref.header, f)), f
    # a span-boundary flip moves one dead slot (the exact test removes it)
    rows = int(ref.header.row_total)
    assert abs(int(got.header.slot_total) - int(ref.header.slot_total)) <= int(
        0.002 * rows)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               atol=1e-2)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=5e-2)
    assert float(got.color[..., :3].max()) > 0.05


def test_row_overflow_sets_flag_and_renders():
    """Row demand beyond the row capacity drops rows, sets the overflow flag
    and still renders a finite frame."""
    ds = heavy(800, 5)
    out = port_frame(ds, 256, 4096 * 16)
    assert int(out.header.row_total) > 256
    assert int(out.header.overflow) == 1
    assert torch.isfinite(out.color).all() and torch.isfinite(out.depth).all()


def test_pick_row_capacity_follows_jax_policy():
    n = 5000
    jr = G.DepthFirstRenderer(G.RendererConfig(), use_xla_blend=True)
    tr = T.DepthFirstRenderer(T.RendererConfig(), device="cpu")
    full = -(-2 * n // 4096) * 4096
    assert jr.pick_row_capacity(n) == tr.pick_row_capacity(n) == full
    for total in (100, 7000, 3 * full, 4 * full, 4 * full + 1):
        kind = f"k{total}"
        jr._cap_feedback = {(kind, n): types.SimpleNamespace(
            row_total=jnp.int32(total), slot_total=None)}
        tr._cap_feedback = {(kind, n): types.SimpleNamespace(
            row_total=torch.tensor(total, dtype=torch.int32), slot_total=None)}
        want = jr.pick_row_capacity(n, kind=kind)
        assert tr.pick_row_capacity(n, kind=kind) == want
        assert want == (0 if total > 4 * full else want) and want >= 0
        # locked in: the next frames reuse it without reading the feedback
        tr._cap_feedback = {}
        assert tr.pick_row_capacity(n, kind=kind) == want
    off = T.DepthFirstRenderer(T.RendererConfig(), device="cpu",
                               adaptive_capacity=False)
    assert off.pick_row_capacity(n) == full


def test_default_renderer_locks_in_row_capacity():
    """RendererConfig() renders with rows on: the first frame uses the full
    row model, the second the locked-in capacity; both frames are equal to
    the rows-off frame."""
    n, w, h = 400, 128, 96
    gi = generate_visible_gaussians(n, sh_degree=1,
                                    scale_range=(0.01, 0.3)).to_input(device="cpu")
    cam = T.make_camera(w, h)
    r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1), device="cpu")
    o1 = r.render(gi, cam, w, h)
    o2 = r.render(gi, cam, w, h)
    cap = r._cap_state[("rows", r._mono_key, n)]["cap"]
    assert int(o2.header.row_total) < cap < 2 * n + 4096 * 2
    off = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1, row_expand=False),
                               device="cpu")
    off.render(gi, cam, w, h)
    o3 = off.render(gi, cam, w, h)
    for o in (o1, o2):
        np.testing.assert_array_equal(o.color.numpy(), o3.color.numpy())
    assert int(o2.header.overflow) == 0


@pytest.mark.parametrize("count,sh_degree,seed", [(20000, 3, 11), (3001, 1, 5)])
def test_realistic_generator_matches_jax(count, sh_degree, seed):
    a = jax_realistic(count, sh_degree=sh_degree, seed=seed)
    b = generate_realistic_gaussians(count, sh_degree=sh_degree, seed=seed)
    for name in ("positions", "scales", "rotations", "opacities", "harmonics"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
