"""Side-by-side stereo parity: gsm_renderer_tpu_torch's dual-eye projection,
stereo prep and expand, dual-eye blend and ``render_stereo`` against the
JAX package (Pallas in interpret mode), twinning tests/test_stereo.py.

Tolerances:
* projection (plain vs ``stereo_project_and_cull_packed(interpret=True)``):
  rect_word, rect_h, visible and the w0 / w2 / w3 words of both eyes
  equal except float-boundary flips, counted and capped at 0.4% of the
  gaussians (two eyes' records: twice the mono cap of 0.2%), an f16 field
  moving at most one f16 step; theta within the
  anisotropy-weighted bound of tests/test_torch_project.py (4 u16 units:
  XLA:CPU contracts FMAs, and its rsqrt -- the mid-camera SH direction --
  differs from 1/sqrt in the last bit).  Where the covariance's
  off-diagonal is a small difference of large terms, the contracted FMAs
  turn the reference's eigenvector further (seen: 12 u16 units off the
  float64 value); for those records (at most 0.2%) the port's theta must
  lie within the bound of the float64 theta instead.  The union pixel
  bounds agree within 1e-3 relative where no flip moved the gaussian (the
  box extents ride the same off-diagonal: 2.6e-4 seen).
* dsw: equal with the identity scene transform; with a scaled and rotated
  one, one depth ulp apart (XLA contracts the transform's multiply-adds
  into FMAs; the kernels build with --fmad=false, as the plain version
  computes).
* prep "stereo" and the expand's dual-eye q <= 9 test, each fed the JAX
  stage's own inputs: offsets, rect words and keys equal, and the 8 words
  JAX carries equal to the entry words at each live slot's index; masks up
  to counted boundary flips (<= 0.2%).
* dual-eye blend (plain, ``n_eyes=2, r2_cutoff=9``) vs
  ``blend_tiles_pallas(..., n_eyes=2, r2_cutoff=9.0, interpret=True)`` on
  the same sorted table (the port reads it through the identity key): max
  |d| <= 1e-5 in both eyes.  Early-exit rule of
  both: after each 256-record batch (2 x 128 aligned) a tile stops once
  every pixel of BOTH eyes has transmittance below 1/255.
* the whole frame vs JAX ``depth_first_stereo_frame(interpret=True)``:
  colour and alpha max |d| <= 1e-2, depth <= 5e-2.
* zero IPD: left == right within 1e-5, and each half within 0.03 of the
  mono frame (the tolerance of tests/test_stereo.py: the r^2 <= 9 cutoff
  drops the faint skirt beyond 3 sigma).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.kernels import blend as JK
from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.kernels.project import \
    stereo_project_and_cull_packed as jax_stereo_project
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines.common import binning_sorted_tile as jax_sorted_tile
from gsm_renderer_tpu.pipelines.depth_first import \
    depth_first_stereo_frame as jax_stereo_frame

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import depth_first as TD
from test_torch_binning import assert_words_at_entries
from test_torch_project import THETA_TOL, f16_steps, theta_error

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

NEAR, FAR = 0.1, 20.0
STATICS = dict(tile_w=16, tile_h=16, near_plane=NEAR, far_plane=FAR,
               alpha_threshold=0.005, total_ink_threshold=2.0,
               input_is_srgb=False)


def i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def ds_to_torch(ds):
    return T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                                 ds.opacities, ds.harmonics, device="cpu")


def scene_transform(kind):
    """Identity, or a rotation about Y by 0.3 rad scaled by 1.25 and moved
    by (0.1, -0.05, 0.2)."""
    if kind == "identity":
        return np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    st = np.eye(4)
    st[:3, :3] = 1.25 * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    st[:3, 3] = [0.1, -0.05, 0.2]
    return st.astype(np.float32)


def rig(w, h, ipd=0.2, st="identity"):
    """(JAX stereo camera, port stereo camera, views, projs, centers, st)
    carried across exactly."""
    cam = G.make_camera(w, h, far=FAR)
    js = G.make_side_by_side_stereo(cam, ipd=ipd)
    views = np.stack([js.left.view_matrix, js.right.view_matrix]).astype(np.float32)
    projs = np.stack([js.left.projection_matrix,
                      js.right.projection_matrix]).astype(np.float32)
    centers = np.stack([js.left.position, js.right.position]).astype(np.float32)
    stm = scene_transform(st)
    js.scene_transform = stm
    ts = T.stereo_camera_from_numpy(views, projs, centers, NEAR, FAR, w, h,
                                    scene_transform=stm)
    return js, ts, views, projs, centers, stm


def test_stereo_camera_carries_across_exactly():
    cam = G.make_camera(160, 120, far=FAR)
    js = G.make_side_by_side_stereo(cam, ipd=0.063)
    ts = T.make_side_by_side_stereo(T.make_camera(160, 120, far=FAR), ipd=0.063)
    for a, b in ((js.left, ts.left), (js.right, ts.right)):
        for name in ("view_matrix", "projection_matrix", "position"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert ts.scene_transform is None
    views, projs, centers, st = js.astuple_jax()
    scale, mid = TP.stereo_constants(np.asarray(centers), scene_transform("scaled"))
    jst = jnp.asarray(scene_transform("scaled"))
    assert scale == np.float32(jnp.linalg.norm(jst[:3, 0]))
    np.testing.assert_array_equal(
        mid, np.asarray(0.5 * (centers[0] + centers[1])))


def theta_u16_f64(ds, i, view, proj, st, w, h):
    """Theta (u16 units) of gaussian i's screen covariance in float64 (EWA
    Jacobian + 0.3 px low-pass; the scene transform applied)."""
    st = st.astype(np.float64)
    scale = np.linalg.norm(st[:3, 0])
    p = st[:3, :3] @ ds.positions[i].astype(np.float64) + st[:3, 3]
    q = ds.rotations[i].astype(np.float64)
    x, y, z, r = q / np.linalg.norm(q)
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
                    [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
                    [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]])
    cov = rot @ np.diag((ds.scales[i].astype(np.float64) * scale) ** 2) @ rot.T
    v3, p4 = view[:3, :3].astype(np.float64), proj.astype(np.float64)
    v = v3 @ p + view[:3, 3]
    fx, fy = w * abs(p4[0, 0]) / 2, h * abs(p4[1, 1]) / 2
    jac = np.array([[fx / v[2], 0, -fx * v[0] / v[2] ** 2],
                    [0, fy / v[2], -fy * v[1] / v[2] ** 2]])
    c2 = jac @ v3 @ cov @ v3.T @ jac.T + 0.3 * np.eye(2)
    major = np.linalg.eigh(c2)[1][:, 1]
    t = np.arctan2(major[1], major[0]) % np.pi
    return int(np.clip(t * 65535.0 / np.pi + 0.5, 0, 65535))


@pytest.mark.parametrize("sh_degree,st", [(1, "identity"), (3, "identity"),
                                          (2, "scaled")])
def test_stereo_project_matches_pallas(sh_degree, st):
    n, w, h = 2000, 320, 240
    ds = jax_gen(n, sh_degree=sh_degree, seed=3, scale_range=(0.004, 0.1))
    rng = np.random.default_rng(3)
    idx = rng.permutation(n)
    ds.positions[idx[:50], 2] *= -1.0          # behind both eyes
    ds.positions[idx[50:100], 0] *= 3.0        # off one eye's screen
    ds.opacities[idx[100:150]] = 0.003         # below the alpha threshold
    _js, _ts, views, projs, centers, stm = rig(w, h, ipd=0.3, st=st)
    tiles = (-(-w // 16)) * (-(-h // 16))
    kw = dict(width=w, height=h, sh_degree=sh_degree, **STATICS)
    ref = jax_stereo_project(
        ds.to_input(), jnp.asarray(views), jnp.asarray(projs),
        jnp.asarray(centers), jnp.asarray(stm), interpret=True,
        key_plan=JB.make_key_plan(tiles, n, near_plane=NEAR, far_plane=FAR),
        **kw)
    got = TP.stereo_project_and_cull_packed(
        ds_to_torch(ds), views, projs, centers, stm,
        key_plan=TB.make_key_plan(tiles, n, near_plane=NEAR, far_plane=FAR),
        **kw)
    assert 0.5 * n < int(np.asarray(ref.visible).sum()) < n
    flipped = np.zeros(n, bool)
    # the depth word is the full float32 depth: one ulp apart where XLA
    # contracted the scene transform's multiply-adds into FMAs
    dsw_r, dsw_g = u32(ref.dsw), u32(got.dsw.numpy())
    assert np.abs(dsw_r - dsw_g).max() <= (1 if st == "scaled" else 0)
    pairs = [(ref.rect_word, got.rect_word), (ref.rect_h, got.rect_h),
             (ref.visible, got.visible)]
    pairs += [(ref.words[k], got.words[k]) for k in (0, 2, 3, 4, 6, 7)]
    for k, (r, g) in enumerate(pairs):
        r, g = u32(r), u32(g.numpy())
        diff = r != g
        flipped |= diff
        if k >= 3 and diff.any():
            assert f16_steps(r[diff], g[diff]).max() <= 1
    for eye, k in ((0, 1), (1, 5)):  # theta u16 + sigma1 f16
        r1, g1 = u32(ref.words[k]), u32(got.words[k].numpy())
        err = theta_error(r1, g1, u32(ref.words[k + 1]))
        for i in np.nonzero(err > THETA_TOL)[0]:
            # XLA's contracted FMAs moved the reference's eigenvector: the
            # port must then lie within the bound of the float64 truth
            t64 = theta_u16_f64(ds, i, views[eye], projs[eye], stm, w, h)
            assert theta_error(np.asarray([t64]), g1[i:i + 1],
                               u32(ref.words[k + 1])[i:i + 1])[0] <= THETA_TOL
        assert (err > THETA_TOL).sum() <= int(0.002 * n)
        flipped |= (r1 >> 16) != (g1 >> 16)
    assert flipped.sum() <= int(0.004 * n), f"{flipped.sum()} flipped"
    for name in ("px_min", "px_max", "py_min", "py_max"):
        np.testing.assert_allclose(getattr(got, name).numpy()[~flipped],
                                   np.asarray(getattr(ref, name))[~flipped],
                                   rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def stereo_chain():
    """The JAX stereo chain (interpret mode) on one 96x64 scene: packed
    projection, stereo prep table, stereo expand, sort, ranges."""
    n, w, h = 500, 96, 64
    ds = jax_gen(n, sh_degree=1, seed=21, scale_range=(0.01, 0.12))
    _js, _ts, views, projs, centers, stm = rig(w, h, ipd=0.25)
    tiles_x, tiles_y = w // 16, h // 16
    plan = JB.make_key_plan(tiles_x * tiles_y, n, near_plane=NEAR,
                            far_plane=FAR)
    pp = jax_stereo_project(ds.to_input(), jnp.asarray(views),
                            jnp.asarray(projs), jnp.asarray(centers),
                            jnp.asarray(stm), width=w, height=h, sh_degree=1,
                            key_plan=plan, interpret=True, **STATICS)
    tab = JE.binning_prep_pallas(pp.rect_word, pp.rect_h, pp.dsw, pp.words,
                                 mode="stereo", interpret=True)
    flat = np.asarray(tab).reshape(tab.shape[0], -1)
    cap = (int(flat[0, n]) // 4096 + 1) * 4096
    outs = JE.expand_slots_pallas(None, None, None, capacity=cap,
                                  tiles_x=tiles_x, exact_test="stereo",
                                  prebuilt_tab=tab, n_gaussians=n,
                                  key_plan=plan.kernel_tuple, interpret=True)
    import jax
    srt = jax.lax.sort(tuple(outs[:10]), num_keys=2, is_stable=False)
    sorted_tile = jax_sorted_tile(srt[0], fused_depth16=False,
                                  plan_tuple=plan.kernel_tuple)
    starts, counts = JB.extract_tile_ranges(sorted_tile, tiles_x * tiles_y)
    return dict(
        n=n, w=w, h=h, tiles_x=tiles_x, tiles_y=tiles_y, cap=cap, plan=plan,
        packed=dict(rect_word=np.asarray(pp.rect_word),
                    rect_h=np.asarray(pp.rect_h),
                    words=[np.asarray(x) for x in pp.words]),
        offsets=flat[0, :n + 1], rect=flat[1, :n], mask=flat[2, :n],
        dsw=flat[3, :n], words=[flat[4 + k, :n] for k in range(8)],
        expand=[np.asarray(o) for o in outs],
        sorted_words=[np.asarray(o) for o in srt[2:]],
        starts=np.asarray(starts), counts=np.asarray(counts))


def test_stereo_prep_matches_pallas(stereo_chain):
    c = stereo_chain
    p = c["packed"]
    offsets, rect, mask, _sums = TE.binning_prep(
        i32(p["rect_word"]), i32(p["rect_h"]), [i32(x) for x in p["words"]],
        mode="stereo")
    flips = u32(mask.numpy()) != u32(c["mask"])
    assert flips.sum() <= int(0.002 * c["n"])
    same = ~flips
    np.testing.assert_array_equal(np.diff(offsets.numpy().astype(np.int64))[same],
                                  np.diff(c["offsets"].astype(np.int64))[same])
    np.testing.assert_array_equal(u32(rect.numpy())[same], u32(c["rect"])[same])
    if not flips.any():
        np.testing.assert_array_equal(offsets.numpy(), c["offsets"])
    assert ((u32(rect.numpy()) & TE.MASKED_BIT) != 0).sum() > 100


def test_stereo_expand_matches_pallas(stereo_chain):
    c = stereo_chain
    plan = TB.make_key_plan(c["tiles_x"] * c["tiles_y"], c["n"],
                            near_plane=NEAR, far_plane=FAR)
    key1, key2, total, overflow = TE.expand_slots(
        i32(c["offsets"]), i32(c["rect"]), i32(c["mask"]), i32(c["dsw"]),
        [i32(x) for x in c["words"]], capacity=c["cap"],
        tiles_x=c["tiles_x"], mode="stereo", key_plan=plan)
    ref = c["expand"]
    for k, g in enumerate([key1, key2]):
        np.testing.assert_array_equal(u32(g.numpy()), u32(ref[k]),
                                      err_msg=f"output {k}")
    assert_words_at_entries(key1, key2, plan.idx_bits, c["words"], ref[2:10])
    assert int(total) == int(ref[10]) and int(overflow) == int(ref[11]) == 0
    # the dual-eye test pruned some union-rect slots
    assert (u32(key1.numpy()) == TE.SENTINEL).sum() > c["cap"] - int(total)


def test_dual_eye_blend_matches_pallas(stereo_chain):
    c = stereo_chain
    table = torch.stack([i32(x) for x in c["sorted_words"]])
    starts, counts = i32(c["starts"]), i32(c["counts"])
    ref = JK.blend_tiles_pallas(
        JK.build_words_table([jnp.asarray(x) for x in c["sorted_words"]],
                             c["cap"]),
        jnp.asarray(c["starts"]), jnp.asarray(c["counts"]),
        tiles_x=c["tiles_x"], tiles_y=c["tiles_y"], n_eyes=2, r2_cutoff=9.0,
        interpret=True)
    identity = torch.arange(c["cap"], dtype=torch.int64)
    got, _processed = TK.blend_tiles_plain(identity, table, 32, starts, counts,
                                           tiles_x=c["tiles_x"], n_eyes=2,
                                           r2_cutoff=9.0, return_processed=True)
    for (rc, rd), (gc, gd) in zip(ref, got):
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-5)
    assert float(got[0][0][..., :3].max()) > 0.05
    assert float(got[1][0][..., :3].max()) > 0.05


def test_dual_eye_exit_waits_for_both_eyes():
    """A tile stops after a batch only when every pixel of both eyes is
    saturated: one eye saturated and the other not keeps compositing."""
    n_rec = 600

    def words(mx, my, op):
        w0 = (np.float16(mx).view(np.uint16).astype(np.int64)
              | (np.float16(my).view(np.uint16).astype(np.int64) << 16))
        w1 = np.float16(40.0).view(np.uint16).astype(np.int64) << 16
        w2 = (np.float16(40.0).view(np.uint16).astype(np.int64)
              | (np.float16(1.0).view(np.uint16).astype(np.int64) << 16))
        w3 = 200 | (100 << 8) | (50 << 16) | (op << 24)
        return [np.full(n_rec, x, np.int64) for x in (w0, w1, w2, w3)]

    left = words(8.0, 8.0, 255)      # opaque: saturates the tile at once
    right = words(8.0, 8.0, 2)       # faint: never saturates
    table = torch.stack([i32((x & 0xFFFFFFFF).astype(np.uint32))
                         for x in left + right])
    starts = torch.zeros(1, dtype=torch.int32)
    counts = torch.full((1,), n_rec, dtype=torch.int32)
    identity = torch.arange(n_rec, dtype=torch.int64)
    both, processed = TK.blend_tiles_plain(identity, table, 32, starts, counts,
                                           tiles_x=1, n_eyes=2, r2_cutoff=9.0,
                                           return_processed=True)
    assert int(processed[0]) == n_rec
    mono = TK.blend_tiles_plain(identity, table[:4], 32, starts, counts,
                                tiles_x=1, return_processed=True)
    assert int(mono[2][0]) == 256     # the left eye alone stops after batch 0


def test_stereo_frame_matches_jax():
    """Under a scaled and rotated scene transform (the identity is covered
    by the projection test and the renderer tests)."""
    st = "scaled"
    n, w, h = 300, 96, 64
    ds = jax_gen(n, sh_degree=1, seed=8, scale_range=(0.01, 0.06))
    _js, _ts, views, projs, centers, stm = rig(w, h, ipd=0.2, st=st)
    kw = dict(width=w, height=h, capacity=8 * 4096, sh_degree=1,
              alpha_threshold=0.005, total_ink_threshold=2.0, near_plane=NEAR,
              far_plane=FAR, input_is_srgb=False)
    ref = jax_stereo_frame(ds.to_input(), jnp.asarray(views), jnp.asarray(projs),
                           jnp.asarray(centers), jnp.asarray(stm),
                           interpret=True, **kw)
    got = TD.depth_first_stereo_frame(ds_to_torch(ds), views, projs, centers,
                                      stm, **kw)
    assert got.color.shape == (h, 2 * w, 4)
    for f in ("visible_count", "total_instances", "overflow"):
        assert abs(int(getattr(got.header, f))
                   - int(getattr(ref.header, f))) <= int(0.002 * n), f
    assert got.header.row_total is None
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               atol=1e-2)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=5e-2)
    assert float(got.color[:, :w, :3].max()) > 0.05
    assert float(got.color[:, w:, :3].max()) > 0.05


def test_stereo_matches_mono_at_zero_ipd():
    w, h = 96, 96
    gi = ds_to_torch(jax_gen(200, sh_degree=0, scale_range=(0.01, 0.05)))
    cam = T.make_camera(w, h)
    r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=0), device="cpu")
    out_s = r.render_stereo(gi, T.make_side_by_side_stereo(cam, ipd=0.0), w, h)
    left, right = out_s.color[:, :w].numpy(), out_s.color[:, w:].numpy()
    np.testing.assert_allclose(left, right, atol=1e-5)
    mono = r.render(gi, cam, w, h).color.numpy()
    np.testing.assert_allclose(left[..., :3], mono[..., :3], atol=0.03)


def test_render_stereo_contract():
    w, h = 128, 96
    gi = ds_to_torch(jax_gen(300, sh_degree=1, scale_range=(0.01, 0.06)))
    r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=1), device="cpu")
    stereo = T.make_side_by_side_stereo(T.make_camera(w, h), ipd=0.2)
    o1 = r.render_stereo(gi, stereo, w, h)
    o2 = r.render_stereo(gi, stereo, w, h)   # locked-in capacity
    cap = r._cap_state[(r._stereo_key, gi.count)]["cap"]
    assert int(o2.header.slot_total) < cap
    np.testing.assert_array_equal(o1.color.numpy(), o2.color.numpy())
    color = o2.color.numpy()
    assert color.shape == (h, 2 * w, 4) and np.isfinite(color).all()
    left, right = color[:, :w, :3], color[:, w:, :3]
    assert left.max() > 0.05 and right.max() > 0.05
    assert np.abs(left - right).max() > 0.01
    assert np.abs(left.mean() - right.mean()) < 0.05
    assert int(o2.header.overflow) == 0
    assert int(o2.header.total_instances) >= int(o2.header.visible_count) > 0


def test_stereo_invisible_eye_unbounded_screen_no_nan():
    """An eye whose perspective divide explodes (the scene in its image
    plane) must not poison the frame: its record mean is the finite
    off-screen constant, so its alpha is exactly 0."""
    w, h = 64, 64
    ds = jax_gen(64, sh_degree=0, scale_range=(0.02, 0.05))
    left = T.make_camera(w, h, far=50.0)
    rot = np.array([[0, 0, -1, 0], [0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                   np.float32)
    right = T.make_camera(w, h, view_matrix=rot, far=50.0)
    stereo = T.StereoCameraParams(left=left, right=right)
    gi = ds_to_torch(ds)
    pp = TP.stereo_project_and_cull_packed(
        gi, np.stack([left.view_matrix, right.view_matrix]),
        np.stack([left.projection_matrix, right.projection_matrix]),
        np.stack([left.position, right.position]), np.eye(4, dtype=np.float32),
        width=w, height=h, sh_degree=0, tile_w=16, tile_h=16, near_plane=0.1,
        far_plane=50.0, alpha_threshold=0.005, total_ink_threshold=2.0,
        input_is_srgb=False)
    assert int(pp.visible.sum()) > 0
    half = (u32(pp.words[4].numpy()) & 0xFFFF).astype(np.uint16).view(np.float16)
    assert np.isfinite(half).all()
    r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=0), device="cpu")
    color = r.render_stereo(gi, stereo, w, h).color.numpy()
    assert np.isfinite(color).all()
    assert color[:, :w, :3].max() > 0.05
