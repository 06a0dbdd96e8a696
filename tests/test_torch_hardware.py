"""Parity of gsm_renderer_tpu_torch's HardwareRenderer (on the CPU: the plain
PyTorch versions of the kernels) against the JAX package and the NumPy
oracle: the mono frame with full rects (prep and the expand in mode "none",
the per-pixel r^2 <= 9 cutoff, normalized depth), its stages, and its
16-bit-depth-key frames.  The stereo and foveated Hardware frames are in
tests/test_torch_hardware_stereo.py.

The JAX side runs its Hardware frame (``depth_first_frame(exact_tile_test=
False, depth_mode="normalized", r2_cutoff=9.0, interpret=True)``, which
takes the XLA projection ``ops/project.py::project_and_cull``) and its
stages (``binning_inputs``, ``expand_slots_pallas(exact_test=False,
interpret=True)``, the sort, ``blend_tiles_pallas(interpret=True)``); they
are computed once per module.

Tolerances:
* the packed projection on the Hardware frame against JAX's XLA projection:
  the visible gaussians' rect words equal ``binning_inputs``' rect words
  (a culled one carries CULLED_BIT on both sides, its rect fields the
  kernel's own) and dsw equals ``KeyPlan.normalize`` of JAX's depth key,
  exactly; the record words equal
  ``pack_record_words(pr.record)`` except theta's u16, held as
  tests/test_torch_project.py holds it (within +-1, or within THETA_TOL u16
  units weighted by the record's anisotropy), with the records beyond that
  counted and capped at 0.2% of the gaussians;
* prep "none" (plain) against ``binning_inputs`` plus the exclusive scan,
  on JAX's own inputs: offsets and rect words equal, no mask;
* the expand in mode "none" (plain) against ``expand_slots_pallas(
  exact_test=False)`` on the same inputs: keys, slot total and overflow
  equal;
* sorted order of the whole chain: tile ranges equal to JAX's, and the
  record words read through each live rank's entry index equal to JAX's
  sorted words except ranks of theta flips (as above), capped at 1% of the
  live ranks;
* the frame: visible_count, total_instances, slot_total and overflow
  equal, row_total None; colour and alpha max |d| <= 1e-2 (the early-exit
  bound 1/255 plus theta flips); normalized depth <= 5e-2 where alpha >
  0.05 (the division by a small alpha magnifies the weighted depth's
  float noise elsewhere);
* the blend (plain) with normalized depth, in one eye with the r^2 <= 9
  cutoff and in two eyes, against ``blend_tiles_pallas(interpret=True)``
  on the same sorted table: colour and alpha within 1e-5, normalized depth
  within 1e-4 relative where alpha > 0.05;
* MESH_SHADERS and INSTANCED frames, and ``back_to_front``, bit-equal;
  ``depth_output=False`` gives the same colour and no depth;
* against tests/reference_impl.py with ``hardware_mode=True``:
  visible_count equal, colour within 0.02 (the JAX package's own
  ``test_hardware_matches_reference``).
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
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.ops.project import project_and_cull as jax_project
from gsm_renderer_tpu.pipelines import common as JC
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_df
from reference_impl import render_reference

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels.project import project_and_cull_packed
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import common as TC
from gsm_renderer_tpu_torch.pipelines.hardware import R2_CUTOFF, hardware_frame

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

W, H, N, FAR = 128, 96, 600, 20.0
CAP = 8 * 4096
COLOR_TOL, DEPTH_TOL = 1e-2, 5e-2
THETA_TOL = 4.0
FLIP_CAP = int(0.002 * N)
TILES_X, TILES_Y = -(-W // 16), -(-H // 16)
STATICS = dict(width=W, height=H, capacity=CAP, sh_degree=1,
               alpha_threshold=0.005, total_ink_threshold=2.0,
               near_plane=0.1, far_plane=FAR, input_is_srgb=False)
HW = dict(exact_tile_test=False, depth_mode="normalized", r2_cutoff=R2_CUTOFF)


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(u32(a).astype(np.uint32)
                                                 .view(np.int32)))


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


def words_differ(want, got):
    """Per record: a word other than theta's u16 differs, or theta lies
    beyond the contract."""
    differ = np.zeros(want[0].shape, bool)
    for k in (0, 2, 3):
        differ |= got[k] != want[k]
    differ |= (got[1] >> 16) != (want[1] >> 16)
    return differ | (theta_error(want[1], got[1], want[2]) > THETA_TOL)


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
def jax_hw(scene):
    """JAX's Hardware frames (32-bit depth keys; 16-bit under both tile-id
    precisions) and the stages of its 32-bit frame, as numpy."""
    jgi, args = scene["ds"].to_input(), scene["jax_args"]
    frames = {}
    for name, kw in (("bits32", {}),
                     ("bits16_tile16", dict(depth_key_bits=16)),
                     ("bits16_tile32", dict(depth_key_bits=16,
                                            tile_id_bits=32))):
        frames[name] = as_np(jax_df(jgi, *args, interpret=True,
                                    blocks_per_dma=4, **STATICS, **HW, **kw))
    kw = {k: v for k, v in STATICS.items() if k != "capacity"}
    pr = jax_project(jgi, *args, tile_w=16, tile_h=16,
                     **{k: v for k, v in kw.items()
                        if k not in ("width", "height")},
                     width=W, height=H)
    words = JC.pack_record_words(pr.record)
    word_list = [words[:, k] for k in range(4)]
    plan = JB.make_key_plan(TILES_X * TILES_Y, N, near_plane=0.1, far_plane=FAR)
    dsw = plan.normalize(pr.depth_key)
    counts, rect_word, mask, aux = JC.binning_inputs(
        pr.visible, pr.min_tx, pr.min_ty, pr.max_tx, pr.rect_count, dsw,
        word_list, exact_test=False)
    assert mask is None
    outs = JE.expand_slots_pallas(counts, rect_word, aux, capacity=CAP,
                                  tiles_x=TILES_X, exact_test=False,
                                  key_plan=plan.kernel_tuple, interpret=True)
    key1, key2, sw = outs[0], outs[1], outs[2:-2]
    ops = jax.lax.sort((key1, key2, *sw), num_keys=2, is_stable=False)
    sorted_tile = JC.binning_sorted_tile(ops[0], fused_depth16=False,
                                         plan_tuple=plan.kernel_tuple)
    starts, tcounts = JB.extract_tile_ranges(sorted_tile, TILES_X * TILES_Y)
    rect_w = pr.max_tx - pr.min_tx + 1
    return dict(
        frames=frames, record_words=[u32(w) for w in word_list],
        visible=np.asarray(pr.visible), dsw=u32(dsw), counts=np.asarray(counts),
        rect_word=u32(rect_word),
        rect_h=np.asarray(pr.rect_count // jnp.maximum(rect_w, 1)),
        key1=u32(key1), key2=u32(key2), total=int(outs[-2]),
        overflow=int(outs[-1]), sorted_words=[u32(w) for w in ops[2:]],
        sorted_tile=u32(sorted_tile), starts=np.array(starts),
        tile_counts=np.array(tcounts))


def port_packed(scene):
    plan = TB.make_key_plan(TILES_X * TILES_Y, N, near_plane=0.1,
                            far_plane=FAR)
    kw = {k: v for k, v in STATICS.items() if k != "capacity"}
    return project_and_cull_packed(scene["gi"], *scene["port_args"],
                                   key_plan=plan, tile_w=16, tile_h=16,
                                   **kw), plan


def test_packed_projection_reproduces_xla_projection(scene, jax_hw):
    """The Hardware frame reuses the packed projection: its rect words,
    depth words and record words are those JAX's XLA projection gives the
    full-rect binning."""
    ref = jax_hw
    packed, _plan = port_packed(scene)
    vis = ref["visible"]
    np.testing.assert_array_equal(packed.visible.numpy(), vis)
    rw = u32(packed.rect_word.numpy())
    np.testing.assert_array_equal(rw[vis], ref["rect_word"][vis])
    # a culled gaussian's rect fields are the kernel's own (JAX packs an
    # empty rect): both carry CULLED_BIT and take one dead slot
    assert ((rw[~vis] & TE.CULLED_BIT) != 0).all()
    assert ((ref["rect_word"][~vis] & TE.CULLED_BIT) != 0).all()
    np.testing.assert_array_equal(u32(packed.dsw.numpy()), ref["dsw"])
    np.testing.assert_array_equal(packed.rect_h.numpy()[vis],
                                  ref["rect_h"][vis])
    got = [u32(w.numpy()) for w in packed.words]
    differ = words_differ(ref["record_words"], got)
    assert differ.sum() <= FLIP_CAP, f"{differ.sum()} records differ"
    assert vis.sum() > N // 2


def test_prep_none_matches_binning_inputs(jax_hw):
    """Prep "none" on JAX's rect words: the offsets are the exclusive scan
    of ``binning_inputs``' counts (max(rect_count, 1): one dead slot for a
    culled gaussian), the rect words pass through, no mask."""
    ref = jax_hw
    rw, rh = i32(ref["rect_word"]), torch.from_numpy(ref["rect_h"].astype(np.int32))
    words = [i32(w) for w in ref["record_words"]]
    offsets, rect, mask, _sums = TE.binning_prep_plain(rw, rh, words,
                                                       mode="none")
    want = np.concatenate([[0], np.cumsum(ref["counts"])])
    np.testing.assert_array_equal(offsets.numpy(), want)
    assert rect is rw and mask is None
    culled = ~ref["visible"]
    assert culled.any()
    np.testing.assert_array_equal(np.diff(offsets.numpy())[culled], 1)
    with pytest.raises(ValueError, match="count_rows"):
        TE.binning_prep_plain(rw, rh, words, mode="none", count_rows=True)


def test_expand_none_matches_pallas(jax_hw):
    """The expand in mode "none" on the same table: keys, slot total and
    overflow equal to ``expand_slots_pallas(exact_test=False)``'s."""
    ref = jax_hw
    rw, rh = i32(ref["rect_word"]), torch.from_numpy(ref["rect_h"].astype(np.int32))
    words = [i32(w) for w in ref["record_words"]]
    offsets, rect, mask, _sums = TE.binning_prep_plain(rw, rh, words,
                                                       mode="none")
    plan = TB.make_key_plan(TILES_X * TILES_Y, N, near_plane=0.1, far_plane=FAR)
    key1, key2, total, overflow = TE.expand_slots_plain(
        offsets, rect, mask, i32(ref["dsw"]), words, capacity=CAP,
        tiles_x=TILES_X, key_plan=plan, mode="none")
    np.testing.assert_array_equal(u32(key1.numpy()), ref["key1"])
    np.testing.assert_array_equal(u32(key2.numpy()), ref["key2"])
    assert int(total) == ref["total"] and int(overflow) == ref["overflow"] == 0
    # every slot of a visible rect is live: no test prunes any
    live = u32(key1.numpy()) != TE.SENTINEL
    assert live.sum() == ref["total"] - (~ref["visible"]).sum()


def test_sorted_order_matches_jax(scene, jax_hw):
    """The port's chain (packed projection, prep and expand in mode "none",
    the keys-only sort) orders the slots as JAX's: equal tile ranges, equal
    words at every live rank but theta flips."""
    ref = jax_hw
    packed, plan = port_packed(scene)
    (key1, key2), words, total, overflow, _sums = TC.binning_sort_operands(
        packed, capacity=CAP, tiles_x=TILES_X, key_plan=plan, mode="none")
    assert int(total) == ref["total"] and int(overflow) == 0
    sorted_key = TC.sort_keys([key1, key2], plan)[0]
    starts, counts, _total = TC.tile_ranges(sorted_key, plan,
                                            TILES_X * TILES_Y)
    np.testing.assert_array_equal(counts.numpy(), ref["tile_counts"])
    np.testing.assert_array_equal(starts.numpy(), ref["starts"])
    tile = TC.binning_sorted_tile(sorted_key, plan_tuple=plan.kernel_tuple)
    live = tile.numpy() != TE.SENTINEL
    np.testing.assert_array_equal(live, ref["sorted_tile"] != TE.SENTINEL)
    entry = (sorted_key.numpy() & ((1 << plan.idx_bits) - 1))[live]
    got = [u32(w.numpy())[entry] for w in words]
    want = [w[live] for w in ref["sorted_words"]]
    differ = words_differ(want, got)
    assert live.sum() > N
    assert differ.sum() <= 0.01 * live.sum(), f"{differ.sum()} ranks differ"


PORT_FRAMES = {
    "bits32": {},
    "bits16_tile16": dict(depth_key_bits=16),
    "bits16_tile32": dict(depth_key_bits=16, tile_id_bits=32),
}


@pytest.mark.parametrize("name", list(PORT_FRAMES))
def test_frame_matches_jax(scene, jax_hw, name):
    ref = jax_hw["frames"][name]
    got = as_np(hardware_frame(scene["gi"], *scene["port_args"], **STATICS,
                               **PORT_FRAMES[name]))
    for f in ("visible_count", "total_instances", "slot_total", "overflow"):
        assert got["header"][f] == ref["header"][f], f
    assert got["header"]["overflow"] == 0
    assert got["header"]["row_total"] is None is ref["header"]["row_total"]
    np.testing.assert_allclose(got["color"], ref["color"], atol=COLOR_TOL)
    seen = ref["color"][..., 3] > 0.05
    assert seen.mean() > 0.15
    np.testing.assert_allclose(got["depth"][seen], ref["depth"][seen],
                               atol=DEPTH_TOL)
    assert float(got["color"][..., :3].max()) > 0.05


def test_bits16_tile_precisions_agree(scene):
    """Hardware with 16-bit depth keys: tile ids 16 and 32 render one
    frame (the d16 KeyPlan, as the DepthFirst BITS16 frames)."""
    a, b = (hardware_frame(scene["gi"], *scene["port_args"], **STATICS, **kw)
            for kw in (PORT_FRAMES["bits16_tile16"],
                       PORT_FRAMES["bits16_tile32"]))
    assert torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)


def blend_case(jax_hw, n_eyes):
    """The JAX frame's sorted words (a second eye: the same records 3 px to
    the left) with its tile spans."""
    w = list(jax_hw["sorted_words"])
    if n_eyes == 2:
        mx = (w[0] & 0xFFFF).astype(np.uint16).view(np.float16)
        mx = (mx.astype(np.float32) - 3.0).astype(np.float16).view(np.uint16)
        w = w + [(w[0] & 0xFFFF0000) | mx.astype(np.int64)] + w[1:]
    return w


@pytest.mark.parametrize("n_eyes", [1, 2])
def test_normalized_cutoff_blend_matches_pallas(jax_hw, n_eyes):
    w = blend_case(jax_hw, n_eyes)
    starts, counts = jax_hw["starts"], jax_hw["tile_counts"]
    ref = JK.blend_tiles_pallas(
        JK.build_words_table([jnp.asarray(x.astype(np.uint32)) for x in w], CAP),
        jnp.asarray(starts), jnp.asarray(counts), tiles_x=TILES_X,
        tiles_y=TILES_Y, depth_mode="normalized", r2_cutoff=R2_CUTOFF,
        n_eyes=n_eyes, blocks_per_dma=4, interpret=True)
    got = TK.blend_tiles_plain(
        torch.arange(CAP, dtype=torch.int64), torch.stack([i32(x) for x in w]),
        32, torch.from_numpy(starts), torch.from_numpy(counts),
        tiles_x=TILES_X, depth_mode="normalized", r2_cutoff=R2_CUTOFF,
        n_eyes=n_eyes)
    pairs = zip(ref, got) if n_eyes == 2 else [(ref, got)]
    for (rc, rd), (gc, gd) in pairs:
        rc, rd = np.asarray(rc), np.asarray(rd)
        np.testing.assert_allclose(gc.numpy(), rc, atol=1e-5)
        seen = rc[..., 3] > 0.05
        np.testing.assert_allclose(gd.numpy()[seen], rd[seen], rtol=1e-4)
        # normalized: the weighted depth over the pixel's alpha
        weighted = TK.blend_tiles_plain(
            torch.arange(CAP, dtype=torch.int64),
            torch.stack([i32(x) for x in w[:4]]), 32,
            torch.from_numpy(starts), torch.from_numpy(counts),
            tiles_x=TILES_X, r2_cutoff=R2_CUTOFF) if n_eyes == 1 else None
        if weighted is not None:
            assert torch.equal(weighted[0], gc)
            assert torch.equal(gd, weighted[1] / torch.clamp(
                weighted[0][..., 3], min=1e-6))
        assert float(gc[..., :3].max()) > 0.05


def test_cutoff_zeroes_alpha_past_r2():
    """A one-eye blend with the cutoff: alpha is exactly 0 where q > 9 and
    unchanged within it."""
    def f16(x):
        return int(np.float16(x).view(np.uint16))

    # one record at pixel (8, 8) of a 16x16 tile, sigma 2 px, opacity 1
    w = [f16(8.0) | (f16(8.0) << 16), f16(2.0) << 16, f16(2.0) | (f16(3.0) << 16),
         0x808080 | (255 << 24)]
    table = torch.tensor(np.array([w], np.int64).T.astype(np.uint32).view(np.int32))
    key, starts, counts = (torch.arange(1, dtype=torch.int64),
                           torch.zeros(1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32))
    cut, _ = TK.blend_tiles_plain(key, table, 32, starts, counts, tiles_x=1,
                                  r2_cutoff=R2_CUTOFF)
    full, _ = TK.blend_tiles_plain(key, table, 32, starts, counts, tiles_x=1)
    p = torch.arange(256)
    q = ((p % 16 - 8.0) ** 2 + (p // 16 - 8.0) ** 2) / 4.0
    assert (cut[0, q > 9.0, 3] == 0).all() and (full[0, q > 9.0, 3] > 0).all()
    assert torch.equal(cut[0, q <= 9.0], full[0, q <= 9.0])


def test_blend_cuda_wrapper_takes_one_eye_cutoff(monkeypatch):
    """The kernel's wrapper takes one eye with a cutoff and normalized
    depth at every tile and depth mode (32x16, first_hit depth, 65x12 and
    4096x1 included) and hands the launch its tile and depth mode; it
    refuses a negative cutoff and a tile side outside 1 to 4096 (it raises
    before it touches a device)."""
    calls = []
    monkeypatch.setattr(TK.BLEND, "launch", lambda *a: calls.append(a))
    key = torch.arange(4, dtype=torch.int64)
    words = torch.zeros((4, 4), dtype=torch.int32)
    starts = counts = torch.zeros(2, dtype=torch.int32)
    kw = dict(tiles_x=2, tiles_y=1, width=32, height=16, r2_cutoff=R2_CUTOFF)
    for ok in (dict(depth_mode="normalized"), dict(tile_w=32),
               dict(depth_mode="first_hit"), dict(tile_w=8, tile_h=32)):
        TK.blend_image_cuda(key, words, 32, starts, counts, **kw, **ok)
        mode = ok.get("depth_mode", "weighted")
        assert calls[-1][11:14] == (ok.get("tile_w", 16), ok.get("tile_h", 16),
                                    TK.DEPTH_MODES[mode])
    with pytest.raises(NotImplementedError, match="cutoff"):
        TK.blend_image_cuda(key, torch.zeros((8, 4), dtype=torch.int32), 32,
                            starts, counts, **dict(kw, r2_cutoff=-1.0),
                            n_eyes=2)
    for tile_w, tile_h in ((65, 12), (4096, 1)):
        TK.blend_image_cuda(key, words, 32, starts, counts, **kw,
                            tile_w=tile_w, tile_h=tile_h)
        assert calls[-1][11:13] == (tile_w, tile_h)
    with pytest.raises(ValueError, match="tile sides of 1 to 4096 pixels"):
        TK.blend_image_cuda(key, words, 32, starts, counts, **kw, tile_w=4097,
                            tile_h=1)
    assert len(calls) == 6


def render(cfg_kw, gi, cam, w, h):
    return T.HardwareRenderer(T.RendererConfig(sh_degree=1, **cfg_kw),
                              device="cpu").render(gi, cam, w, h)


def test_backend_and_order_invariance():
    """MESH_SHADERS and INSTANCED, and back_to_front, render one frame
    (the twin of tests/test_pipeline_variants.py::
    test_hardware_back_to_front_equivalent, which allows 0.02 in JAX: here
    the frames are the same frame); depth_output=False gives the same
    colour and no depth."""
    w, h = 96, 64
    gi = port_input(jax_gen(200, sh_degree=1, scale_range=(0.01, 0.05)))
    cam = T.make_camera(w, h)
    base = render({}, gi, cam, w, h)
    assert base.header.row_total is None
    assert float(base.color[..., :3].max()) > 0.05
    for opt in (dict(hardware_backend=T.HardwareBackend.INSTANCED),
                dict(back_to_front=True)):
        out = render(opt, gi, cam, w, h)
        assert torch.equal(out.color, base.color), opt
        assert torch.equal(out.depth, base.depth), opt
    out = render(dict(depth_output=False), gi, cam, w, h)
    assert out.depth is None and torch.equal(out.color, base.color)


def test_renderer_frame_is_hardware_frame(scene):
    """HardwareRenderer.render is ``hardware_frame`` at the full-rect
    capacity (8 x gaussians) under its own capacity kind; the locked
    capacity renders the same frame."""
    r = T.HardwareRenderer(T.RendererConfig(sh_degree=1, max_width=W,
                                            max_height=H), device="cpu")
    cam = T.make_camera(W, H, far=FAR)
    o1 = r.render(scene["gi"], cam, W, H)
    o2 = r.render(scene["gi"], cam, W, H)
    assert r._cap_state[("hw", N)]["cap"] < 8 * N + 4096
    ref = hardware_frame(scene["gi"], *scene["port_args"],
                         **dict(STATICS, capacity=-(-8 * N // 4096) * 4096))
    for o in (o1, o2):
        assert torch.equal(o.color, ref.color) and torch.equal(o.depth, ref.depth)
        assert int(o.header.overflow) == 0


def test_hardware_matches_reference_oracle():
    w, h = 128, 96
    ds = jax_gen(250, sh_degree=0)
    cam = T.make_camera(w, h)
    ref_color, _, aux = render_reference(
        ds, cam.view_matrix, cam.projection_matrix, cam.position, w, h,
        sh_degree=0, tile_w=16, tile_h=16, hardware_mode=True)
    out = T.HardwareRenderer(T.RendererConfig(sh_degree=0),
                             device="cpu").render(port_input(ds), cam, w, h)
    assert int(out.header.visible_count) == aux["visible"]
    assert int(out.header.overflow) == 0
    np.testing.assert_allclose(out.color.numpy()[..., :3], ref_color[..., :3],
                               atol=0.02)


def test_hardware_close_to_depth_first():
    """Twin of the JAX package's four-renderer agreement: the Hardware
    colour within a mean |d| of 0.01 of DepthFirst's (the r^2 <= 9 cutoff
    drops the faint skirt the exact test keeps)."""
    w, h = 96, 96
    gi = port_input(jax_gen(200, sh_degree=1, scale_range=(0.01, 0.05)))
    cam = T.make_camera(w, h)
    cfg = T.RendererConfig(sh_degree=1)
    hw = T.HardwareRenderer(cfg, device="cpu").render(gi, cam, w, h)
    df = T.DepthFirstRenderer(cfg, device="cpu").render(gi, cam, w, h)
    diff = float((hw.color[..., :3] - df.color[..., :3]).abs().mean())
    assert diff < 0.01, diff
