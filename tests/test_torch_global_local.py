"""Whole-frame parity of gsm_renderer_tpu_torch's Global and Local renderers
and of its DepthFirst frame with 16-bit depth keys (on the CPU: the plain
PyTorch versions of the kernels) against the JAX package and the NumPy
oracle, plus their contract.

The JAX frames (``global_frame``, ``local_frame`` and
``depth_first_frame(depth_key_bits=16, tile_id_bits=16 / 32)``, all with
``interpret=True``, the production Pallas path) and the JAX d16 chain
(``pipelines/common.py::d16_packed_sorted``) are computed once per module.

Tolerances:
* sorted order: the port's tile ranges equal JAX's, and the record words
  the port reads through each live rank's entry index equal JAX's sorted
  words, except at ranks of float-boundary flips of the projection, counted
  and capped at 1% of the live ranks (a flip moves a record within its
  tile, so a few neighbouring ranks differ with it).  Theta's u16 is held
  as tests/test_torch_project.py holds it: within +-1, or within THETA_TOL
  u16 units weighted by the record's anisotropy (XLA:CPU's contracted FMAs
  turn the eigenvector of a near-isotropic covariance); a rank beyond that
  counts as a flip;
* header: overflow and (DepthFirst) row_total equal; visible_count,
  total_instances and slot_total equal up to the projection's counted flips
  (0.2% of the gaussians; flips move slot counts by a tile or two);
* colour and alpha max |d| <= 1e-2 against JAX (the early-exit bound
  1/255 plus flips); weighted depth <= 5e-2;
* first-hit depth (Local): equal to JAX's except at pixels where a
  record's alpha lies within float noise of the 0.1 threshold, counted
  and capped at 0.5% of the pixels;
* against tests/reference_impl.py (Global, Local, DepthFirst BITS16):
  visible_count equal, colour <= 0.05, as the JAX package's own Local test
  allows (16-bit depth keys reorder near-equal depths, which the oracle
  sorts in 32 bits).
"""

import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu.io.scene import GaussianDataset
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines.common import d16_packed_sorted as jax_d16
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_df
from gsm_renderer_tpu.pipelines.global_ import global_frame as jax_global
from gsm_renderer_tpu.pipelines.local import local_frame as jax_local
from reference_impl import render_reference

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels.expand import SENTINEL
from gsm_renderer_tpu_torch.pipelines import common as TC
from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame
from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
from gsm_renderer_tpu_torch.pipelines.local import local_frame

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

W, H, N, FAR = 128, 96, 600, 20.0
COLOR_TOL, DEPTH_TOL = 1e-2, 5e-2
FLIP_CAP = int(0.002 * N)
STATICS = dict(width=W, height=H, capacity=4096, sh_degree=1,
               alpha_threshold=0.005, total_ink_threshold=2.0,
               near_plane=0.1, far_plane=FAR, input_is_srgb=False)


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


THETA_TOL = 4.0


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


def port_input(ds):
    return T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                                 ds.opacities, ds.harmonics, device="cpu")


def as_np(out):
    return dict(color=np.asarray(out.color), depth=np.asarray(out.depth),
                header={f: (None if getattr(out.header, f) is None
                            else int(getattr(out.header, f)))
                        for f in ("visible_count", "total_instances",
                                  "overflow", "slot_total", "row_total")})


@pytest.fixture(scope="module")
def scene():
    ds = jax_gen(N, sh_degree=1, scale_range=(0.01, 0.06))
    cam = G.make_camera(W, H, far=FAR)
    return dict(ds=ds, cam=cam, jax_args=cam.astuple_jax(), gi=port_input(ds),
                port_args=(cam.view_matrix, cam.projection_matrix,
                           cam.position))


@pytest.fixture(scope="module")
def jax_frames(scene):
    """The JAX interpret-mode frames and d16 chains, as numpy."""
    jgi, args = scene["ds"].to_input(), scene["jax_args"]
    frames = {
        "global": as_np(jax_global(jgi, *args, interpret=True, **STATICS)),
        "local": as_np(jax_local(jgi, *args, interpret=True, **STATICS)),
    }
    for bits in (16, 32):
        frames[f"df16_tile{bits}"] = as_np(jax_df(
            jgi, *args, interpret=True, depth_key_bits=16, tile_id_bits=bits,
            row_capacity=0, **STATICS))
    chains = {}
    for tile_w in (32, 16):
        tiles_x, tiles_y = -(-W // tile_w), -(-H // 16)
        kw = {k: v for k, v in STATICS.items() if k != "capacity"}
        sorted_tile, sw, total, overflow, _vis = jax_d16(
            jgi, *args, capacity=STATICS["capacity"], tiles_x=tiles_x,
            tile_w=tile_w, tile_h=16, interpret=True, **kw)
        starts, counts = JB.extract_tile_ranges(sorted_tile, tiles_x * tiles_y)
        chains[tile_w] = dict(words=[u32(w) for w in sw[-4:]],
                              sorted_tile=u32(sorted_tile),
                              starts=np.asarray(starts),
                              counts=np.asarray(counts), total=int(total),
                              overflow=int(overflow))
    return dict(frames=frames, chains=chains)


PORT_FRAMES = {
    "global": lambda gi, args: global_frame(gi, *args, **STATICS),
    "local": lambda gi, args: local_frame(gi, *args, **STATICS),
    "df16_tile16": lambda gi, args: depth_first_frame(
        gi, *args, depth_key_bits=16, tile_id_bits=16, **STATICS),
    "df16_tile32": lambda gi, args: depth_first_frame(
        gi, *args, depth_key_bits=16, tile_id_bits=32, **STATICS),
}


@pytest.fixture(scope="module")
def port_frames(scene):
    return {name: fn(scene["gi"], scene["port_args"])
            for name, fn in PORT_FRAMES.items()}


@pytest.mark.parametrize("tile_w", [32, 16])
def test_sorted_order_matches_jax(scene, jax_frames, tile_w):
    """The port's d16 KeyPlan chain orders the slots as JAX's stable
    fused-key sort: equal tile ranges, equal words at every rank."""
    ref = jax_frames["chains"][tile_w]
    tiles_x, tiles_y = -(-W // tile_w), -(-H // 16)
    kw = {k: v for k, v in STATICS.items() if k != "capacity"}
    plan = TC.d16_key_plan(tiles_x * tiles_y, N)
    srt, packed, total, overflow, _sums = TC.d16_packed_sorted(
        scene["gi"], *scene["port_args"], key_plan=plan,
        capacity=STATICS["capacity"], tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_w, tile_h=16, **kw)
    assert plan.kernel_tuple[1] == 0  # d_lo = 0: key1 = tile | depth16
    sorted_key, starts, counts = srt.key, srt.starts, srt.counts
    assert int(overflow) == ref["overflow"] == 0
    assert abs(int(total) - ref["total"]) <= FLIP_CAP
    np.testing.assert_array_equal(counts.numpy(), ref["counts"])
    np.testing.assert_array_equal(starts.numpy(), ref["starts"])
    tile = TC.binning_sorted_tile(sorted_key, plan_tuple=plan.kernel_tuple)
    live = tile.numpy() != SENTINEL
    np.testing.assert_array_equal(live, ref["sorted_tile"] != SENTINEL)
    entry = (sorted_key.numpy() & ((1 << plan.idx_bits) - 1))[live]
    got = [u32(w.numpy())[entry] for w in packed.words]
    want = [w[live] for w in ref["words"]]
    differ = np.zeros(int(live.sum()), bool)
    for k in (0, 2, 3):
        differ |= got[k] != want[k]
    differ |= (got[1] >> 16) != (want[1] >> 16)
    differ |= theta_error(want[1], got[1], want[2]) > THETA_TOL
    assert live.sum() > N
    assert differ.sum() <= 0.01 * live.sum(), f"{differ.sum()} ranks differ"


@pytest.mark.parametrize("name", list(PORT_FRAMES))
def test_frame_matches_jax(jax_frames, port_frames, name):
    ref, got = jax_frames["frames"][name], as_np(port_frames[name])
    rh, gh = ref["header"], got["header"]
    assert gh["overflow"] == rh["overflow"] == 0
    for f in ("visible_count", "total_instances", "slot_total"):
        assert abs(gh[f] - rh[f]) <= FLIP_CAP, (f, gh[f], rh[f])
    if name.startswith("df16"):
        assert gh["row_total"] == rh["row_total"]
    else:
        assert gh["row_total"] is None
    np.testing.assert_allclose(got["color"], ref["color"], atol=COLOR_TOL)
    if name == "local":
        flips = np.abs(got["depth"] - ref["depth"]) > DEPTH_TOL
        assert flips.sum() <= 0.005 * W * H, f"{flips.sum()} depth flips"
    else:
        np.testing.assert_allclose(got["depth"], ref["depth"], atol=DEPTH_TOL)
    assert float(got["color"][..., :3].max()) > 0.05


def test_jax_and_port_tile_precisions_agree(jax_frames, port_frames):
    """DepthFirst with 16-bit depth keys: the two tile-id precisions give
    bit-equal frames, in JAX (fused key vs d16 KeyPlan) and in the port;
    Local's colour is DepthFirst BITS16's where no tile is clamped."""
    a, b = jax_frames["frames"]["df16_tile16"], jax_frames["frames"]["df16_tile32"]
    np.testing.assert_array_equal(a["color"], b["color"])
    np.testing.assert_array_equal(a["depth"], b["depth"])
    p16, p32 = port_frames["df16_tile16"], port_frames["df16_tile32"]
    np.testing.assert_array_equal(p16.color.numpy(), p32.color.numpy())
    np.testing.assert_array_equal(p16.depth.numpy(), p32.depth.numpy())
    loc = port_frames["local"]
    np.testing.assert_array_equal(loc.color.numpy(), p16.color.numpy())
    assert int(loc.header.total_instances) == int(p16.header.total_instances)


@pytest.mark.parametrize("cls,opt,tile_w", [
    (T.GlobalRenderer, {}, 32), (T.LocalRenderer, {}, 16),
    (T.DepthFirstRenderer,
     dict(depth_sort_key_precision=T.DepthSortKeyPrecision.BITS16), 16)],
    ids=["global", "local", "depth16"])
def test_renderer_matches_reference_oracle(cls, opt, tile_w):
    w, h = 128, 96
    ds = jax_gen(250, sh_degree=0)
    cam = T.make_camera(w, h)
    ref_color, _, aux = render_reference(
        ds, cam.view_matrix, cam.projection_matrix, cam.position, w, h,
        sh_degree=0, tile_w=tile_w, tile_h=16)
    out = cls(T.RendererConfig(sh_degree=0, **opt), device="cpu").render(
        port_input(ds), cam, w, h)
    assert int(out.header.visible_count) == aux["visible"]
    assert int(out.header.overflow) == 0
    np.testing.assert_allclose(out.color.numpy()[..., :3], ref_color[..., :3],
                               atol=0.05)


def test_local_first_hit_depth():
    """Twin of tests/test_pipeline_variants.py::test_local_first_hit_depth:
    the Local depth is the first alpha > 0.1 record's, the near gaussian's
    2.0, not the alpha-weighted depth."""
    w, h = 64, 64
    pos = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 4.0]], np.float32)
    scales = np.full((2, 3), 0.4, np.float32)
    quats = np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1))
    ops = np.array([0.6, 0.9], np.float32)
    harm = np.zeros((2, 1, 3), np.float32)
    harm[:, 0, :] = 0.5
    ds = GaussianDataset(pos, scales, quats, ops, harm)
    cam = T.make_camera(w, h)
    out = T.LocalRenderer(T.RendererConfig(sh_degree=0), device="cpu").render(
        port_input(ds), cam, w, h)
    assert abs(float(out.depth[h // 2, w // 2]) - 2.0) < 0.05
    weighted = T.GlobalRenderer(T.RendererConfig(sh_degree=0),
                                device="cpu").render(port_input(ds), cam, w, h)
    # the alpha-weighted depth mixes in the far gaussian
    assert abs(float(weighted.depth[h // 2, w // 2]) - 2.0) > 0.5
    corner = out.depth[0, 0]
    assert float(corner) == 0.0 and float(out.color[0, 0, 3]) < 0.1


def test_local_clamp_matches_jax():
    """A dense scene with ``max_per_tile`` 32: the clamp drops each tile's
    records past 32 from the blend and from total_instances, not from
    slot_total, as JAX's local_frame does."""
    w, h, n, mpt = 64, 48, 250, 32
    ds = jax_gen(n, sh_degree=0, seed=4, scale_range=(0.05, 0.15))
    cam = G.make_camera(w, h, far=FAR)
    kw = dict(STATICS, width=w, height=h, sh_degree=0, max_per_tile=mpt)
    ref = as_np(jax_local(ds.to_input(), *cam.astuple_jax(), interpret=True,
                          **kw))
    gi = port_input(ds)
    args = (cam.view_matrix, cam.projection_matrix, cam.position)
    got = local_frame(gi, *args, **kw)
    full = local_frame(gi, *args, **dict(kw, max_per_tile=4096))
    gh, rh = as_np(got)["header"], ref["header"]
    assert int(full.header.total_instances) > gh["total_instances"]
    assert gh["slot_total"] == int(full.header.slot_total)
    assert gh["total_instances"] <= mpt * (w // 16) * (h // 16)
    for f in ("visible_count", "total_instances", "slot_total"):
        assert abs(gh[f] - rh[f]) <= int(0.002 * n) + 1, (f, gh[f], rh[f])
    np.testing.assert_allclose(got.color.numpy(), ref["color"], atol=COLOR_TOL)
    flips = np.abs(got.depth.numpy() - ref["depth"]) > DEPTH_TOL
    assert flips.sum() <= 0.005 * w * h
    assert not np.allclose(got.color.numpy(), full.color.numpy(), atol=1e-3)


@pytest.mark.parametrize("cls", [T.GlobalRenderer, T.LocalRenderer])
def test_render_stereo_raises(cls):
    gi = jax_gen(20)
    stereo = T.make_side_by_side_stereo(T.make_camera(64, 48))
    with pytest.raises(NotImplementedError,
                       match=f"^{cls.__name__} does not support stereo rendering$"):
        cls(device="cpu").render_stereo(port_input(gi), stereo, 64, 48)


def test_global_tile_id_guard():
    """257 x 256 tiles of 32x16 do not fit 16-bit tile ids: JAX's message."""
    w, h = 8224, 4096
    r = T.GlobalRenderer(T.RendererConfig(max_width=w, max_height=h),
                         device="cpu")
    with pytest.raises(ValueError, match=r"^GlobalRenderer tile id must fit 16 "
                                         r"bits \(65792 tiles\)$"):
        r.render(port_input(jax_gen(20)), T.make_camera(w, h), w, h)


def test_renderers_agree_roughly():
    """Twin of tests/test_pipeline_variants.py::
    test_all_four_renderers_agree_roughly for the ported renderers: Global
    and Local within a mean |d| of 0.01 of DepthFirst."""
    w, h = 96, 96
    gi = port_input(jax_gen(200, sh_degree=1, scale_range=(0.01, 0.05)))
    cam = T.make_camera(w, h)
    cfg = T.RendererConfig(sh_degree=1)
    outs = {cls.__name__: cls(cfg, device="cpu").render(gi, cam, w, h).color
            for cls in (T.DepthFirstRenderer, T.GlobalRenderer, T.LocalRenderer)}
    base = outs["DepthFirstRenderer"][..., :3]
    assert float(base.max()) > 0.05
    for name in ("GlobalRenderer", "LocalRenderer"):
        diff = float((outs[name][..., :3] - base).abs().mean())
        assert diff < 0.01, (name, diff)


def test_capacity_locks_in_per_renderer():
    """Global and Local keep their own capacity kind; the locked capacity
    renders the same frame as the first, full-model one."""
    gi = port_input(jax_gen(800, sh_degree=0, scale_range=(0.005, 0.03)))
    cam = T.make_camera(W, H)
    for cls in (T.GlobalRenderer, T.LocalRenderer):
        r = cls(T.RendererConfig(sh_degree=0), device="cpu")
        o1, o2 = r.render(gi, cam, W, H), r.render(gi, cam, W, H)
        cap = r._cap_state[(r._mono_key, 800)]["cap"]
        assert int(o1.header.slot_total) < cap
        assert int(o2.header.overflow) == 0
        np.testing.assert_array_equal(o1.color.numpy(), o2.color.numpy())
        np.testing.assert_array_equal(o1.depth.numpy(), o2.depth.numpy())
