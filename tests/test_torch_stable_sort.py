"""The stable-sort fallback of gsm_renderer_tpu_torch (no tie-free KeyPlan
fits) against the JAX package.

* Binning with no KeyPlan, 32-bit depth keys (480x320) and 16-bit depth
  keys on a grid past 65,535 tiles (4608x3840: 288x240 tiles, 300
  gaussians): JAX's chain with ``key_plan=None`` -- the Pallas projection
  (the raw depth key, or the half-depth key), ``binning_sort_operands(
  key_plan=None, packed=..., use_pallas=True, interpret=True)`` and the
  stable 2-key ``jax.lax.sort`` -- against the port's expand with the plain
  tile key and its stable sort on JAX's own prep table.  Exactly equal:
  per slot the tile key, and at live slots the depth word and the words
  JAX carries (read by the port through its entry plane); per rank the
  tile, the depth word and the words; the tile ranges.
* The port's chains with the plan set to None render their KeyPlan frames
  bit for bit: ``mono_packed_sorted`` (exact-tested, and mode "none"),
  ``d16_packed_sorted``, and the stereo and foveated frames' binning;
  equal tile ranges and equal colour and depth, or equal sorted entries.
* The case the fallback serves: ``make_key_plan`` finds no plan for 4M
  gaussians on a 3840x2160 grid of 16x16 tiles with far 1000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu.io.scene import generate_visible_gaussians
from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.kernels.project import project_and_cull_packed as jax_project
from gsm_renderer_tpu.ops import binning as JB
from gsm_renderer_tpu.pipelines.common import binning_sort_operands as jax_operands

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.io.scene import (
    generate_visible_gaussians as port_gen)
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels.blend import blend_image
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import common as TC
from gsm_renderer_tpu_torch.pipelines import depth_first as TD

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

NEAR, FAR = 0.1, 20.0
SENTINEL = 0xFFFFFFFF


def i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def jax_fallback_chain(n, w, h, *, seed, scale_range, depth_key16):
    """JAX's binning with no KeyPlan, in interpret mode: the prep table's
    planes, the expand's (key, depth, w0..w3) per slot and their stable
    2-key sort, as numpy."""
    ds = generate_visible_gaussians(n, sh_degree=1, seed=seed,
                                    scale_range=scale_range)
    view, proj, center = G.make_camera(w, h, far=FAR).astuple_jax()
    tiles_x = -(-w // 16)
    packed = jax_project(ds.to_input(), view, proj, center, width=w, height=h,
                         tile_w=16, tile_h=16, sh_degree=1, near_plane=NEAR,
                         far_plane=FAR, alpha_threshold=0.005,
                         total_ink_threshold=2.0, input_is_srgb=False,
                         key_plan=None, depth_key16=depth_key16,
                         interpret=True)
    tab = np.asarray(JE.binning_prep_pallas(
        packed.rect_word, packed.rect_h, packed.dsw, packed.words,
        interpret=True))
    flat = tab.reshape(tab.shape[0], -1)
    capacity = (int(flat[0, n]) // 4096 + 1) * 4096
    ops, (num_keys, is_stable, drop), plan_tuple, total, overflow = \
        jax_operands(None, None, None, None, None, None, None,
                     capacity=capacity, tiles_x=tiles_x, fused_depth16=False,
                     use_pallas=True, interpret=True, exact_test=True,
                     key_plan=None, packed=packed)
    assert plan_tuple is None and (num_keys, is_stable, drop) == (2, True, 1)
    srt = jax.lax.sort(ops, num_keys=2, is_stable=True)
    return dict(offsets=flat[0, :n + 1], rect=flat[1, :n], mask=flat[2, :n],
                dsw=flat[3, :n], words=[flat[4 + k, :n] for k in range(4)],
                capacity=capacity, tiles_x=tiles_x,
                tiles=tiles_x * -(-h // 16),
                slots=[np.asarray(o) for o in ops],
                sorted=[np.asarray(o) for o in srt], total=int(total),
                overflow=int(overflow))


@pytest.fixture(scope="module", params=["depth32", "depth16_69120_tiles"])
def chain(request):
    if request.param == "depth32":
        return jax_fallback_chain(1500, 480, 320, seed=11,
                                  scale_range=(0.005, 0.12),
                                  depth_key16=False)
    return jax_fallback_chain(300, 4608, 3840, seed=13,
                              scale_range=(0.002, 0.02), depth_key16=True)


def port_fallback(chain):
    """The port's plain-key expand on JAX's prep table: (tile, depth word,
    entry index, total, overflow)."""
    return TE.expand_slots(
        i32(chain["offsets"]), i32(chain["rect"]), i32(chain["mask"]),
        i32(chain["dsw"]), [i32(w) for w in chain["words"]],
        capacity=chain["capacity"], tiles_x=chain["tiles_x"], key_plan=None)


def test_fallback_expand_matches_jax(chain):
    tile, depth, entry, total, overflow = port_fallback(chain)
    key, d_slot, *words = chain["slots"]
    live = u32(key) != SENTINEL
    np.testing.assert_array_equal(u32(tile.numpy()), u32(key))
    np.testing.assert_array_equal(u32(depth.numpy())[live], u32(d_slot)[live])
    assert (u32(depth.numpy())[~live] == SENTINEL).all()
    assert (u32(entry.numpy())[~live] == SENTINEL).all()
    g = u32(entry.numpy())[live]
    for k, (w, ref) in enumerate(zip(chain["words"], words, strict=True)):
        np.testing.assert_array_equal(u32(w)[g], u32(ref)[live],
                                      err_msg=f"word {k}")
    assert int(total) == chain["total"] and int(overflow) == chain["overflow"] == 0
    assert live.sum() > 300


def test_fallback_sort_matches_jax_stable_sort(chain):
    tile, depth, entry, _total, _overflow = port_fallback(chain)
    srt = TC.sort_and_ranges([tile, depth, entry], None, chain["tiles"])
    assert srt.idx_bits == 32
    sorted_key, sorted_entry = TC.sort_instances_stable(tile, depth, entry)
    np.testing.assert_array_equal(srt.key.numpy(), sorted_entry.numpy())
    sk = sorted_key.numpy()
    k1, k2 = ((sk >> 32) & 0xFFFFFFFF) ^ 0x80000000, sk & 0xFFFFFFFF
    ref_key, ref_depth, *ref_words = chain["sorted"]
    live = u32(ref_key) != SENTINEL
    np.testing.assert_array_equal(k1, u32(ref_key))
    np.testing.assert_array_equal(k2[live], u32(ref_depth)[live])
    g = sorted_entry.numpy()[live]
    for k, (w, ref) in enumerate(zip(chain["words"], ref_words, strict=True)):
        np.testing.assert_array_equal(u32(w)[g], u32(ref)[live],
                                      err_msg=f"word {k}")
    starts, counts = JB.extract_tile_ranges(jnp.asarray(ref_key),
                                            chain["tiles"])
    np.testing.assert_array_equal(srt.starts.numpy(), np.asarray(starts))
    np.testing.assert_array_equal(srt.counts.numpy(), np.asarray(counts))
    assert srt.counts.sum() > 300


W, H, N = 256, 192, 2500


@pytest.fixture(scope="module")
def scene():
    ds = port_gen(N, sh_degree=1, seed=3, scale_range=(0.005, 0.06))
    cam = T.make_camera(W, H, far=FAR)
    return dict(gi=ds.to_input(device="cpu"), cam=cam,
                args=(cam.view_matrix, cam.projection_matrix, cam.position))


STATICS = dict(width=W, height=H, capacity=16 * N + 4096, tiles_x=16,
               tiles_y=12, tile_w=16, tile_h=16, sh_degree=1,
               alpha_threshold=0.005, total_ink_threshold=2.0,
               near_plane=NEAR, far_plane=FAR, input_is_srgb=False)


def blend(srt, words, **kw):
    return blend_image(srt.key, words, srt.idx_bits, srt.starts, srt.counts,
                       tiles_x=16, tiles_y=12, width=W, height=H, **kw)


@pytest.mark.parametrize("mode", ["mono", "none"])
def test_mono_chain_without_plan_renders_the_keyplan_frame(scene, mode):
    plan = TD.d32_key_plan(N, width=W, height=H, tile_w=16, tile_h=16,
                                near_plane=NEAR, far_plane=FAR)
    assert plan is not None
    kw = dict(depth_mode="normalized", r2_cutoff=9.0) if mode == "none" else {}
    frames = []
    for key_plan in (plan, None):
        srt, _packed, words, total, overflow, _sums = TC.mono_packed_sorted(
            scene["gi"], *scene["args"], key_plan=key_plan, mode=mode,
            **STATICS)
        assert int(overflow) == 0
        frames.append((srt, total, blend(srt, words, **kw)))
    (s0, t0, (c0, d0)), (s1, t1, (c1, d1)) = frames
    assert s1.idx_bits == 32 and int(t0) == int(t1)
    assert torch.equal(s0.starts, s1.starts) and torch.equal(s0.counts, s1.counts)
    assert torch.equal(c0, c1) and torch.equal(d0, d1)
    assert float(c0[..., :3].max()) > 0.05
    # and the frame function is that KeyPlan frame
    out = TD.depth_first_frame(
        scene["gi"], *scene["args"], exact_tile_test=mode == "mono",
        **{k: v for k, v in STATICS.items() if k not in ("tiles_x", "tiles_y")},
        **kw)
    assert torch.equal(out.color, c1)


def test_d16_chain_without_plan_renders_the_keyplan_frame(scene):
    plan = TC.d16_key_plan(16 * 12, N)
    frames = []
    for key_plan in (plan, None):
        srt, packed, total, overflow, _sums = TC.d16_packed_sorted(
            scene["gi"], *scene["args"], key_plan=key_plan, **STATICS)
        assert int(overflow) == 0
        frames.append((srt, blend(srt, packed.words)))
    (s0, (c0, d0)), (s1, (c1, d1)) = frames
    assert torch.equal(s0.starts, s1.starts) and torch.equal(s0.counts, s1.counts)
    assert torch.equal(c0, c1) and torch.equal(d0, d1)


def test_stereo_binning_without_plan_orders_as_the_keyplan(scene):
    stereo = T.make_side_by_side_stereo(scene["cam"], ipd=0.1)
    rig = TD._stereo_rig(stereo)
    plan = TB.make_key_plan(16 * 12, N, near_plane=NEAR, far_plane=FAR)
    kw = {k: v for k, v in STATICS.items()
          if k not in ("tiles_y", "tile_w", "tile_h")}
    out = []
    for key_plan in (plan, None):
        _pp, keys, words, _total, overflow, _sums = TD._stereo_packed_ops(
            scene["gi"], *rig, None, key_plan, tile_w=16, tile_h=16, **kw)
        assert int(overflow) == 0
        srt = TC.sort_and_ranges(keys, key_plan, 16 * 12)
        entry = srt.key & ((1 << srt.idx_bits) - 1)
        out.append((srt, entry))
    (s0, e0), (s1, e1) = out
    assert torch.equal(s0.starts, s1.starts) and torch.equal(s0.counts, s1.counts)
    live = int(s0.counts.sum())
    assert live > N and torch.equal(e0[:live], e1[:live])


def test_foveated_binning_without_plan_orders_as_the_keyplan(scene):
    """The foveated frame's chain (display-size projection, re-binning onto
    the physical tiles, warped prep and expand) with the plan set to None
    sorts its slots into the KeyPlan order."""
    stereo = T.make_side_by_side_stereo(scene["cam"], ipd=0.1)
    target = T.make_rate_maps(W, H, min_rate=0.4, radius=0.3)
    tables = TD.foveated_device_tables(target, "cpu")
    tiles_x = -(-target.render_width // 16)
    num_tiles = tiles_x * -(-target.render_height // 16)
    assert num_tiles < 16 * 12  # the physical grid is the reduced one
    plan = TB.make_key_plan(num_tiles, N, near_plane=NEAR, far_plane=FAR)
    kw = {k: v for k, v in STATICS.items()
          if k not in ("width", "height", "tiles_x", "tiles_y")}
    out = []
    for key_plan in (plan, None):
        _pp, keys, _words, _total, overflow, _sums = TD._foveated_packed_ops(
            scene["gi"], *TD._stereo_rig(stereo), None, key_plan, tables,
            display_width=W, display_height=H, tiles_x=tiles_x,
            tiles_y=num_tiles // tiles_x, foveated_lod=0.0, **kw)
        assert int(overflow) == 0
        srt = TC.sort_and_ranges(keys, key_plan, num_tiles)
        out.append((srt, srt.key & ((1 << srt.idx_bits) - 1)))
    (s0, e0), (s1, e1) = out
    assert s1.idx_bits == 32
    assert torch.equal(s0.starts, s1.starts) and torch.equal(s0.counts, s1.counts)
    live = int(s0.counts.sum())
    assert live > N and torch.equal(e0[:live], e1[:live])


def test_no_plan_for_4m_gaussians_at_4k():
    """The configuration chip_smoke.py's phase 4s renders: 3840x2160 at
    16x16 tiles, 4M gaussians, far 1000 -- no tie-free KeyPlan, in the
    port and in JAX; the 16-bit keys still fit."""
    for make in (TB.make_key_plan, JB.make_key_plan):
        assert make(240 * 135, 4_000_000, near_plane=0.1, far_plane=1000.0) is None
        assert make(240 * 135, 4_000_000, depth_span_bits=16) is not None
