"""Frame keywords of the JAX package's frame functions in
gsm_renderer_tpu_torch (on the CPU: the plain PyTorch versions of the
kernels), against the JAX package's interpret-mode frames.

* ``depth_first_frame(max_per_tile=N)``: each tile's count clamped to N
  before the blend, rows off (JAX takes its XLA binning path there,
  ``pipelines/depth_first.py:142-145``).  The header is JAX's on that path:
  ``total_instances`` is the visible gaussians' rect total (sum of
  rect_w * rect_h, JAX's ``total_live``), not the clamped count;
  ``slot_total`` is prep's, the same as without the clamp: JAX's
  ``fused_binning`` runs the same Pallas prep over the same rects (its
  ``use_prep`` holds for the mono exact test).  Held with 32- and 16-bit
  depth keys, with ``row_capacity`` set (and ignored), and with a clamp
  that clamps nothing.
* ``global_frame(exact_tile_test=False)``: full-rect instances at 32x16
  under the d16 KeyPlan against JAX's XLA binning of full rects under its
  fused [tile:16 | depth16:16] key, sorted stably: equal tile ranges, the
  record words at every live rank equal JAX's sorted words (but theta's
  u16, and ranks of counted float-boundary flips, capped at 1% as in
  tests/test_torch_global_local.py), and the frame.
* ``back_to_front``: accepted and ignored by ``depth_first_frame``,
  ``global_frame`` and ``hardware_frame``, as in JAX: bit-equal frames.
* refusals: a tile side of 0 or over 4096 pixels raises ValueError in
  every frame function and kernel wrapper of the port.

Frames: every header field equal (visible_count, total_instances,
overflow, slot_total, row_total); colour and alpha max |d| <= 1e-2,
weighted depth <= 5e-2 against JAX.  JAX's frames are computed once per
module (fixture ``jax_frames``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu import mathlib as JM
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.ops.project import project_and_cull as jax_project_xla
from gsm_renderer_tpu.pipelines.common import fused_binning as jax_fused_binning
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_df
from gsm_renderer_tpu.pipelines.global_ import global_frame as jax_global

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.parallel import multichip as TM
from gsm_renderer_tpu_torch.pipelines import common as TC
from gsm_renderer_tpu_torch.pipelines import depth_first as TD
from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
from gsm_renderer_tpu_torch.pipelines.hardware import hardware_frame
from gsm_renderer_tpu_torch.pipelines.local import local_frame

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

W, H, N, NEAR, FAR = 128, 96, 300, 0.1, 20.0
COLOR_TOL, DEPTH_TOL = 1e-2, 5e-2
THETA_TOL = 4.0
STATICS = dict(width=W, height=H, capacity=4096, sh_degree=1,
               alpha_threshold=0.005, total_ink_threshold=2.0,
               near_plane=NEAR, far_plane=FAR, input_is_srgb=False)
HEADER = ("visible_count", "total_instances", "overflow", "slot_total",
          "row_total")
#: name -> (JAX frame, port frame, keyword arguments)
FRAMES = {
    "max_per_tile_4": (jax_df, TD.depth_first_frame, dict(max_per_tile=4)),
    "max_per_tile_4_rows": (jax_df, TD.depth_first_frame,
                            dict(max_per_tile=4, row_capacity=8192)),
    "max_per_tile_4_depth16": (jax_df, TD.depth_first_frame,
                               dict(max_per_tile=4, depth_key_bits=16)),
    "max_per_tile_100000": (jax_df, TD.depth_first_frame,
                            dict(max_per_tile=100000)),
    "global_no_exact_test": (jax_global, global_frame,
                             dict(exact_tile_test=False)),
}


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


def header(h):
    return {f: (None if getattr(h, f) is None else int(getattr(h, f)))
            for f in HEADER}


@pytest.fixture(scope="module")
def scene():
    ds = jax_gen(N, sh_degree=1, scale_range=(0.01, 0.06))
    cam = G.make_camera(W, H, far=FAR)
    gi = T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                               ds.opacities, ds.harmonics, device="cpu")
    return dict(ds=ds, jgi=ds.to_input(), jax_args=cam.astuple_jax(), gi=gi,
                port_args=(cam.view_matrix, cam.projection_matrix,
                           cam.position))


@pytest.fixture(scope="module")
def jax_frames(scene):
    out = {name: jax.tree_util.tree_map(
               np.asarray, jfn(scene["jgi"], *scene["jax_args"],
                               interpret=True, **kw, **STATICS))
           for name, (jfn, _pfn, kw) in FRAMES.items()}
    out["default"] = jax.tree_util.tree_map(
        np.asarray, jax_df(scene["jgi"], *scene["jax_args"], interpret=True,
                           **STATICS))
    return out


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, jax_frames, name):
    _jfn, pfn, kw = FRAMES[name]
    ref = jax_frames[name]
    got = pfn(scene["gi"], *scene["port_args"], **kw, **STATICS)
    assert header(got.header) == header(ref.header)
    assert int(got.header.overflow) == 0
    np.testing.assert_allclose(got.color.numpy(), ref.color, atol=COLOR_TOL)
    np.testing.assert_allclose(got.depth.numpy(), ref.depth, atol=DEPTH_TOL)
    assert float(got.color[..., :3].max()) > 0.05


def test_max_per_tile_clamps_and_reports_rect_total(scene, jax_frames):
    """The clamp drops each tile's instances past N from the blend; the
    header's total_instances is the visible rect total, above the live
    count of the unclamped frame, and slot_total is the unclamped
    frame's, in JAX and in the port."""
    args = (scene["gi"], *scene["port_args"])
    clamped = TD.depth_first_frame(*args, max_per_tile=4, **STATICS)
    full = TD.depth_first_frame(*args, **STATICS)
    packed = TP.project_and_cull_packed(
        scene["gi"], *scene["port_args"], tile_w=16, tile_h=16,
        **{k: v for k, v in STATICS.items() if k != "capacity"})
    rect_total = TE.visible_rect_total(packed.rect_word, packed.rect_h,
                                       packed.visible)
    assert int(clamped.header.total_instances) == int(rect_total)
    assert int(rect_total) > int(full.header.total_instances)
    assert int(clamped.header.slot_total) == int(full.header.slot_total)
    ref, ref_full = jax_frames["max_per_tile_4"], jax_frames["default"]
    assert int(ref.header.total_instances) == int(rect_total)
    assert int(ref.header.slot_total) == int(ref_full.header.slot_total)
    assert not np.allclose(clamped.color.numpy(), full.color.numpy(),
                           atol=1e-3)
    unclamped = TD.depth_first_frame(*args, max_per_tile=100000, **STATICS)
    assert torch.equal(unclamped.color, full.color)
    assert torch.equal(unclamped.depth, full.depth)


def test_global_no_exact_test_order_matches_jax(scene):
    """Full rects under the d16 KeyPlan order the slots as JAX's stable sort
    of the fused [tile:16 | depth16:16] key over its XLA full-rect binning:
    equal tile ranges, equal words at every rank."""
    tiles_x, tiles_y = -(-W // 32), -(-H // 16)
    kw = {k: v for k, v in STATICS.items() if k != "capacity"}
    pr = jax_project_xla(scene["jgi"], *scene["jax_args"], tile_w=32,
                         tile_h=16, **kw)
    depth16 = JM.half_depth_key16(pr.record.depth.astype(jnp.float32))
    sorted_tile, _sw4, _live, overflow, sw, total = jax_fused_binning(
        pr, depth16, capacity=STATICS["capacity"], tiles_x=tiles_x,
        fused_depth16=True, use_pallas=True, interpret=True,
        exact_test=False, tile_w=32, tile_h=16, alpha_threshold=0.005)
    starts, counts = JB.extract_tile_ranges(sorted_tile, tiles_x * tiles_y)
    plan = TC.d16_key_plan(tiles_x * tiles_y, N)
    srt, packed, p_total, p_overflow, _sums = TC.d16_packed_sorted(
        scene["gi"], *scene["port_args"], key_plan=plan,
        capacity=STATICS["capacity"], tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=32, tile_h=16, mode="none", **kw)
    assert int(p_overflow) == int(overflow) == 0
    assert int(p_total) == int(total)
    np.testing.assert_array_equal(srt.starts.numpy(), np.asarray(starts))
    np.testing.assert_array_equal(srt.counts.numpy(), np.asarray(counts))
    live = int(srt.counts.sum())
    entry = TK.entry_index(srt.key[:live], srt.idx_bits).numpy()
    got = [u32(w.numpy())[entry] for w in packed.words]
    want = [u32(w)[:live] for w in sw]
    differ = np.zeros(live, bool)
    for k in (0, 2, 3):
        differ |= got[k] != want[k]
    differ |= (got[1] >> 16) != (want[1] >> 16)
    differ |= theta_error(want[1], got[1], want[2]) > THETA_TOL
    assert live > N
    assert differ.sum() <= 0.01 * live, f"{differ.sum()} ranks differ"


@pytest.mark.parametrize("frame", ["depth_first", "global", "hardware"])
def test_back_to_front_renders_the_same_frame(scene, frame):
    fn = {"depth_first": TD.depth_first_frame, "global": global_frame,
          "hardware": hardware_frame}[frame]
    args = (scene["gi"], *scene["port_args"])
    a = fn(*args, back_to_front=True, **STATICS)
    b = fn(*args, back_to_front=False, **STATICS)
    assert torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)
    assert header(a.header) == header(b.header)


def _stereo_rig():
    stereo = T.make_side_by_side_stereo(T.make_camera(W, H, far=FAR))
    return TD._stereo_rig(stereo)


REFUSERS = {
    "depth_first_frame": lambda sc, kw: TD.depth_first_frame(
        sc["gi"], *sc["port_args"], **kw, **STATICS),
    "global_frame": lambda sc, kw: global_frame(
        sc["gi"], *sc["port_args"], **kw, **STATICS),
    "local_frame": lambda sc, kw: local_frame(
        sc["gi"], *sc["port_args"], **kw, **STATICS),
    "hardware_frame": lambda sc, kw: hardware_frame(
        sc["gi"], *sc["port_args"], **kw, **STATICS),
    "depth_first_stereo_frame": lambda sc, kw: TD.depth_first_stereo_frame(
        sc["gi"], *_stereo_rig(), **kw, **STATICS),
    "depth_first_stereo_foveated_frame":
        lambda sc, kw: TD.depth_first_stereo_foveated_frame(
            sc["gi"], *_stereo_rig(), None, display_width=W,
            display_height=H, render_width=W, render_height=H, **kw,
            **{k: v for k, v in STATICS.items()
               if k not in ("width", "height")}),
    "build_sharded_depth_first": lambda sc, kw: TM.build_sharded_depth_first(
        width=W, height=H, n_total=N, device="cpu", **kw),
    "project_plain": lambda sc, kw: TP.project_and_cull_packed(
        sc["gi"], *sc["port_args"], **kw,
        **{k: v for k, v in STATICS.items() if k != "capacity"}),
    "prep_cuda": lambda sc, kw: TE.binning_prep_cuda(
        torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
        [torch.zeros(4, dtype=torch.int32)] * 4, **kw),
    "row_expand_cuda": lambda sc, kw: TE.row_expand_cuda(
        torch.zeros(5, dtype=torch.int32),
        *[torch.zeros(4, dtype=torch.int32)] * 3,
        [torch.zeros(4, dtype=torch.int32)] * 4, row_capacity=8, **kw),
    "expand_cuda": lambda sc, kw: TE.expand_slots_cuda(
        torch.zeros(5, dtype=torch.int32),
        *[torch.zeros(4, dtype=torch.int32)] * 3,
        [torch.zeros(4, dtype=torch.int32)] * 4, capacity=8, tiles_x=1,
        key_plan=None, **kw),
    "blend_cuda": lambda sc, kw: TK.blend_image_cuda(
        torch.arange(4, dtype=torch.int64), torch.zeros((4, 4), dtype=torch.int32),
        32, torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), tiles_x=1, tiles_y=1, width=12,
        height=12, **kw),
}


@pytest.mark.parametrize("name", list(REFUSERS))
@pytest.mark.parametrize("tile", [(0, 16), (16, 4097), (4097, 16)],
                         ids=["0x16", "16x4097", "4097x16"])
def test_tile_sides_other_than_8_16_32_raise(scene, name, tile):
    """Every frame function and kernel wrapper takes tile sides of 1 to
    4096 pixels (tests/test_torch_tiles*.py render them) and refuses a side
    outside that range with ValueError, giving the reason.  (The name is
    older than the range.)"""
    with pytest.raises(ValueError, match="tile sides of 1 to 4096 pixels"):
        REFUSERS[name](scene, dict(tile_w=tile[0], tile_h=tile[1]))
