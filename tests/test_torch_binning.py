"""Binning parity: prep, expand, sort and tile ranges of
gsm_renderer_tpu_torch vs the JAX package's Pallas kernels (interpret mode).

Each port stage is fed the JAX stage's own inputs:

* prep: the port's plain ``binning_prep`` on the JAX projection outputs vs
  ``binning_prep_pallas``.  Offsets, rect words, counts and the slot total
  are equal; the 8x4 masks may differ only by float-boundary flips (the
  minQuadRect <= log-cutoff test, cos/sin/log differ by an ulp between XLA
  and PyTorch), counted (at most 0.2% of the gaussians) and each checked to
  lie within 1e-4 (relative) of its cutoff in float64.
* expand: the port's plain ``expand_slots`` on the JAX prep table vs
  ``expand_slots_pallas(prebuilt_tab=..., key_plan=...)``: key1, key2,
  total and overflow exactly equal, including an overflowing capacity.  The
  port carries no words per slot; the four words JAX carries equal the
  entry table's words at each live slot's index (key2's KeyPlan index
  field) and are zero at dead slots.
* sort + ranges: the port's int64-key ``torch.sort`` of the keys alone and
  ``extract_tile_ranges`` vs ``jax.lax.sort`` + the JAX ranges: exactly
  equal, and the words JAX sorts along equal the entry words read through
  the sorted keys.
* the all-ties scene of tests/test_exact_ordering.py through the port:
  per-tile instance order equals the NumPy oracle's.
* 32x16 tiles with 16-bit depth keys (the Global renderer's chain, fixture
  ``chain32``): the JAX projection in mode ``depth_key16``, then prep at
  ``tile_w=32`` (held as above) and the JAX ``fused_depth16`` expand
  against the port's expand over the d16 KeyPlan: per slot the tile and
  the 16-bit depth key of the fused key equal the port key1's fields
  (key1 = tile << d_hi | depth16), the carried words equal the entry words
  at key2's index, total and overflow equal; and JAX's stable sort of the
  fused key orders the records exactly as the port's unstable sort of its
  key pair: equal tile ranges, equal words at every rank.
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
from gsm_renderer_tpu.pipelines.common import binning_sorted_tile as jax_sorted_tile
from reference_impl import min_quad_rect, render_reference

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.kernels import project as TP
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.pipelines import common as TC

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

N, W, H = 1500, 480, 320
NEAR, FAR = 0.1, 20.0
TILES_X, TILES_Y = -(-W // 16), -(-H // 16)


def i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


@pytest.fixture(scope="module")
def chain():
    """The JAX Pallas chain (interpret mode) on one scene, as numpy."""
    ds = generate_visible_gaussians(N, sh_degree=1, seed=11,
                                    scale_range=(0.005, 0.12))
    cam = G.make_camera(W, H, far=FAR)
    view, proj, center = cam.astuple_jax()
    plan = JB.make_key_plan(TILES_X * TILES_Y, N, near_plane=NEAR,
                            far_plane=FAR)
    packed = jax_project(ds.to_input(), view, proj, center, width=W, height=H,
                         tile_w=16, tile_h=16, sh_degree=1, near_plane=NEAR,
                         far_plane=FAR, alpha_threshold=0.005,
                         total_ink_threshold=2.0, input_is_srgb=False,
                         key_plan=plan, interpret=True)
    tab = JE.binning_prep_pallas(packed.rect_word, packed.rect_h, packed.dsw,
                                 packed.words, interpret=True)

    def expand(capacity):
        outs = JE.expand_slots_pallas(
            None, None, None, capacity=capacity, tiles_x=TILES_X,
            exact_test=True, prebuilt_tab=tab, n_gaussians=N,
            key_plan=plan.kernel_tuple, interpret=True)
        return [np.asarray(o) for o in outs]

    flat = np.asarray(tab).reshape(tab.shape[0], -1)
    total = int(flat[0, N])
    cap = (total // 4096 + 1) * 4096       # fits: overflow 0
    small = cap - 4096                     # below the total: overflow 1
    assert small >= 4096
    outs = expand(cap)
    srt = jax.lax.sort(tuple(jnp.asarray(o) for o in outs[:6]), num_keys=2,
                       is_stable=False)
    sorted_tile = jax_sorted_tile(srt[0], fused_depth16=False,
                                  plan_tuple=plan.kernel_tuple)
    starts, counts = JB.extract_tile_ranges(sorted_tile, TILES_X * TILES_Y)
    return dict(
        packed=dict(rect_word=np.asarray(packed.rect_word),
                    rect_h=np.asarray(packed.rect_h), dsw=np.asarray(packed.dsw),
                    words=[np.asarray(w) for w in packed.words]),
        offsets=flat[0, :N + 1], rect=flat[1, :N], mask=flat[2, :N],
        dsw=flat[3, :N], words=[flat[4 + k, :N] for k in range(4)],
        capacity={"full": cap, "small": small},
        expand={"full": outs, "small": expand(small)}, plan=plan,
        sorted=[np.asarray(o) for o in srt],
        sorted_tile=np.asarray(sorted_tile), starts=np.asarray(starts),
        counts=np.asarray(counts))


def assert_words_at_entries(key1, key2, idx_bits, entry_words, ref_words):
    """The words the JAX chain carries per slot (``ref_words``) equal the
    entry table's words at each live slot's entry index, the low
    ``idx_bits`` bits of key2, and are zero at dead slots (sentinel key1)."""
    k1, k2 = u32(key1), u32(key2)
    live = k1 != TE.SENTINEL
    entry = k2[live] & ((1 << idx_bits) - 1)
    assert live.any()
    for k, (w, r) in enumerate(zip(entry_words, ref_words, strict=True)):
        np.testing.assert_array_equal(u32(w)[entry], u32(r)[live],
                                      err_msg=f"word {k}")
        assert (u32(r)[~live] == 0).all(), f"word {k} at dead slots"


def port_plan():
    return TB.make_key_plan(TILES_X * TILES_Y, N, near_plane=NEAR, far_plane=FAR)


TILES_X32 = -(-W // 32)


@pytest.fixture(scope="module")
def chain32():
    """The JAX Global chain (interpret mode) at 32x16 tiles: projection
    with the half-depth key, prep, fused_depth16 expand and its stable
    sort, as numpy."""
    ds = generate_visible_gaussians(N, sh_degree=1, seed=12,
                                    scale_range=(0.005, 0.12))
    cam = G.make_camera(W, H, far=FAR)
    view, proj, center = cam.astuple_jax()
    packed = jax_project(ds.to_input(), view, proj, center, width=W, height=H,
                         tile_w=32, tile_h=16, sh_degree=1, near_plane=NEAR,
                         far_plane=FAR, alpha_threshold=0.005,
                         total_ink_threshold=2.0, input_is_srgb=False,
                         depth_key16=True, interpret=True)
    tab = JE.binning_prep_pallas(packed.rect_word, packed.rect_h, packed.dsw,
                                 packed.words, tile_w=32, interpret=True)
    flat = np.asarray(tab).reshape(tab.shape[0], -1)
    cap = (int(flat[0, N]) // 4096 + 1) * 4096
    outs = JE.expand_slots_pallas(
        None, None, None, capacity=cap, tiles_x=TILES_X32, exact_test=True,
        fused_depth16=True, prebuilt_tab=tab, n_gaussians=N, tile_w=32,
        interpret=True)
    # (key, dsw, w0..w3) in slot order, then total and overflow
    srt = jax.lax.sort((outs[0],) + tuple(outs[2:6]), num_keys=1,
                       is_stable=True)
    sorted_tile = jax_sorted_tile(srt[0], fused_depth16=True, plan_tuple=None)
    starts, counts = JB.extract_tile_ranges(sorted_tile, TILES_X32 * TILES_Y)
    return dict(
        packed=dict(rect_word=np.asarray(packed.rect_word),
                    rect_h=np.asarray(packed.rect_h), dsw=np.asarray(packed.dsw),
                    words=[np.asarray(w) for w in packed.words]),
        offsets=flat[0, :N + 1], rect=flat[1, :N], mask=flat[2, :N],
        dsw=flat[3, :N], words=[flat[4 + k, :N] for k in range(4)],
        capacity=cap, expand=[np.asarray(o) for o in outs],
        sorted=[np.asarray(o) for o in srt], starts=np.asarray(starts),
        counts=np.asarray(counts))


def d16_plan():
    return TB.make_key_plan(TILES_X32 * TILES_Y, N, depth_span_bits=16)


def test_key_plan_matches_jax(chain):
    assert port_plan().kernel_tuple == chain["plan"].kernel_tuple
    assert (port_plan().near_key, port_plan().span) == (chain["plan"].near_key,
                                                        chain["plan"].span)


def _mask_flip_gaps(mask_ref, mask_got, p, flips, tile_w=16):
    """Relative gap |d2min - cutoff| / cutoff, in float64, of every flipped
    mask bit (computed from the quantized record; tiles of tile_w x 16)."""
    gaps = []
    w0, w1, w2, w3 = (u32(w) for w in p["words"])
    rw = u32(p["rect_word"])
    for i in np.nonzero(flips)[0]:
        half = lambda h: float(np.uint16(h).view(np.float16))  # noqa: E731
        mx, my = half(w0[i] & 0xFFFF), half(w0[i] >> 16)
        th = float(w1[i] & 0xFFFF) * (3.14159265358979 / 65535.0)
        s1 = max(half(w1[i] >> 16), 1e-4)
        s2 = max(half(w2[i] & 0xFFFF), 1e-4)
        c, s = np.cos(th), np.sin(th)
        iv1, iv2 = 1 / (s1 * s1), 1 / (s2 * s2)
        ca, cb, cc = c * c * iv1 + s * s * iv2, c * s * (iv1 - iv2), s * s * iv1 + c * c * iv2
        op = float((w3[i] >> 24) & 0xFF) / 255.0
        cut = -2.0 * np.log(0.005 / op)
        x0 = (rw[i] & 0x3FF) * float(tile_w) - mx
        y0 = ((rw[i] >> 10) & 0x3FF) * 16.0 - my
        for b in range(32):
            if ((int(mask_ref[i]) ^ int(mask_got[i])) >> b) & 1:
                xmin, ymin = x0 + (b % 8) * float(tile_w), y0 + (b // 8) * 16.0
                d2 = min_quad_rect(xmin, xmin + tile_w, ymin, ymin + 16.0, ca,
                                   cb, cc)
                gaps.append(abs(d2 - cut) / cut)
    return gaps


def test_prep_matches_pallas(chain):
    _assert_prep_matches(chain, 16)


def test_prep_tile_w32_matches_pallas(chain32):
    _assert_prep_matches(chain32, 32)


def _assert_prep_matches(chain, tile_w):
    p = chain["packed"]
    offsets, rect, mask = TE.binning_prep(
        i32(p["rect_word"]), i32(p["rect_h"]), [i32(w) for w in p["words"]],
        tile_w=tile_w)
    mask_ref, mask_got = u32(chain["mask"]), u32(mask.numpy())
    flips = mask_ref != mask_got
    assert flips.sum() <= int(0.002 * N), f"{flips.sum()} mask flips"
    assert all(g < 1e-4 for g in _mask_flip_gaps(mask_ref, mask_got, p, flips,
                                                  tile_w))
    same = ~flips
    off_ref, off_got = chain["offsets"].astype(np.int64), offsets.numpy()
    cnt_ref, cnt_got = np.diff(off_ref), np.diff(off_got)
    np.testing.assert_array_equal(cnt_got[same], cnt_ref[same])
    np.testing.assert_array_equal(u32(rect.numpy())[same], u32(chain["rect"])[same])
    if not flips.any():
        np.testing.assert_array_equal(off_got, off_ref)
    assert off_got[N] == off_ref[N]  # slot total
    # invariants expand and the header rely on
    assert (cnt_got >= 1).all()
    eligible_empty = ((u32(rect.numpy()) & TE.MASKED_BIT) != 0) & (u32(mask.numpy()) == 0)
    assert ((u32(rect.numpy())[eligible_empty] & TE.CULLED_BIT) != 0).all()


@pytest.mark.parametrize("which", ["full", "small"])
def test_expand_matches_pallas(chain, which):
    ref = chain["expand"][which]
    capacity = chain["capacity"][which]
    key1, key2, total, overflow = TE.expand_slots(
        i32(chain["offsets"]), i32(chain["rect"]), i32(chain["mask"]),
        i32(chain["dsw"]), [i32(w) for w in chain["words"]], capacity=capacity,
        tiles_x=TILES_X, key_plan=port_plan())
    for k, (r, g) in enumerate(zip(ref[:2], [key1, key2])):
        np.testing.assert_array_equal(u32(g.numpy()), u32(r), err_msg=f"output {k}")
    assert_words_at_entries(key1, key2, port_plan().idx_bits, chain["words"],
                            ref[2:6])
    assert int(total) == int(ref[6])
    assert int(overflow) == int(ref[7])
    assert int(overflow) == (1 if which == "small" else 0)


def test_expand_d16_tile_w32_matches_fused_key(chain32):
    """The port's expand over the d16 KeyPlan against JAX's fused
    [tile:16 | depth16:16] key, slot for slot."""
    plan = d16_plan()
    d_hi, d_lo, idx_bits = plan.kernel_tuple
    assert d_lo == 0 and d_hi >= 16
    ref = chain32["expand"]
    key1, key2, total, overflow = TE.expand_slots(
        i32(chain32["offsets"]), i32(chain32["rect"]), i32(chain32["mask"]),
        i32(chain32["dsw"]), [i32(w) for w in chain32["words"]],
        capacity=chain32["capacity"], tiles_x=TILES_X32, key_plan=plan,
        tile_w=32)
    k1, jkey = u32(key1.numpy()), u32(ref[0])
    live = jkey != TE.SENTINEL
    np.testing.assert_array_equal(k1 != TE.SENTINEL, live)
    np.testing.assert_array_equal(k1[live] >> d_hi, jkey[live] >> 16)
    np.testing.assert_array_equal(k1[live] & ((1 << d_hi) - 1),
                                  jkey[live] & 0xFFFF)
    assert_words_at_entries(key1, key2, idx_bits, chain32["words"], ref[2:6])
    assert int(total) == int(ref[6])
    assert int(overflow) == int(ref[7]) == 0
    assert live.sum() > N


def test_sort_d16_tile_w32_matches_stable_fused_sort(chain32):
    """JAX's stable sort of the fused key and the port's unstable sort of
    the d16 KeyPlan pair give the same records at every rank."""
    plan = d16_plan()
    sorted_key = TC.sort_instances(*_port_keys(chain32, plan))
    starts, counts = TC.tile_ranges(sorted_key, plan, TILES_X32 * TILES_Y)
    np.testing.assert_array_equal(starts.numpy(), chain32["starts"])
    np.testing.assert_array_equal(counts.numpy(), chain32["counts"])
    sk = sorted_key.numpy()
    k1, k2 = ((sk >> 32) & 0xFFFFFFFF) ^ 0x80000000, sk & 0xFFFFFFFF
    assert_words_at_entries(k1, k2, plan.idx_bits, chain32["words"],
                            chain32["sorted"][1:5])
    assert counts.sum() > N


def _port_keys(chain32, plan):
    key1, key2, _total, _overflow = TE.expand_slots(
        i32(chain32["offsets"]), i32(chain32["rect"]), i32(chain32["mask"]),
        i32(chain32["dsw"]), [i32(w) for w in chain32["words"]],
        capacity=chain32["capacity"], tiles_x=TILES_X32, key_plan=plan,
        tile_w=32)
    return key1, key2


def test_sort_and_ranges_match_jax(chain):
    ref = chain["expand"]["full"]
    sorted_key = TC.sort_instances(i32(ref[0]), i32(ref[1]))
    tile = TC.binning_sorted_tile(sorted_key, plan_tuple=port_plan().kernel_tuple)
    np.testing.assert_array_equal(tile.numpy(), u32(chain["sorted_tile"]))
    sk = sorted_key.numpy()
    k1, k2 = ((sk >> 32) & 0xFFFFFFFF) ^ 0x80000000, sk & 0xFFFFFFFF
    np.testing.assert_array_equal(k1, u32(chain["sorted"][0]))
    np.testing.assert_array_equal(k2, u32(chain["sorted"][1]))
    assert_words_at_entries(k1, k2, port_plan().idx_bits, chain["words"],
                            chain["sorted"][2:6])
    starts, counts = TB.extract_tile_ranges(tile, TILES_X * TILES_Y)
    np.testing.assert_array_equal(starts.numpy(), chain["starts"])
    np.testing.assert_array_equal(counts.numpy(), chain["counts"])
    assert counts.sum() > N  # non-trivial lists


def _port_tile_lists(ds, cam, w, h):
    """Per-tile gaussian-index lists of the port's sorted instances (the
    index rides in key2's low KeyPlan bits)."""
    tiles_x, tiles_y = -(-w // 16), -(-h // 16)
    gi = ds.to_input(device="cpu")
    plan = TB.make_key_plan(tiles_x * tiles_y, gi.count, near_plane=0.1,
                            far_plane=10.0)
    packed = TP.project_and_cull_packed(
        gi, cam.view_matrix, cam.projection_matrix, cam.position, width=w,
        height=h, tile_w=16, tile_h=16, sh_degree=0, near_plane=0.1,
        far_plane=10.0, alpha_threshold=0.005, total_ink_threshold=2.0,
        input_is_srgb=False, key_plan=plan)
    (k1, k2), _words, _total, overflow = TC.binning_sort_operands(
        packed, capacity=8192, tiles_x=tiles_x, key_plan=plan)
    assert int(overflow) == 0
    sorted_key = TC.sort_instances(k1, k2)
    tile = TC.binning_sorted_tile(sorted_key, plan_tuple=plan.kernel_tuple)
    starts, counts = TB.extract_tile_ranges(tile, tiles_x * tiles_y)
    idx = (sorted_key & ((1 << plan.idx_bits) - 1)).numpy()
    return {t: idx[int(s):int(s) + int(c)].tolist()
            for t, (s, c) in enumerate(zip(starts, counts)) if int(c)}


@pytest.mark.parametrize("constant_depth", [False, True])
def test_port_per_tile_order_matches_oracle(constant_depth):
    """Port twin of tests/test_exact_ordering.py: per-tile membership and
    order equal the NumPy oracle's; with every gaussian at one depth, the
    ties are ordered by gaussian index through the unstable sort."""
    from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians as gen
    w, h = 128, 96
    ds = gen(300 if constant_depth else 400, sh_degree=0,
             scale_range=(0.01, 0.08))
    if constant_depth:
        ds.positions[:, 2] = 2.0
    cam = T.make_camera(w, h)
    _c, _d, aux = render_reference(ds, cam.view_matrix, cam.projection_matrix,
                                   cam.position, w, h, sh_degree=0)
    oracle = {t: [aux["records"][r]["index"] for r in ranks]
              for t, ranks in aux["tile_lists"].items()}
    got = _port_tile_lists(ds, cam, w, h)
    assert set(got) == set(oracle)
    for t in sorted(oracle):
        assert got[t] == oracle[t], f"tile {t}: {got[t]} != {oracle[t]}"
    assert max(len(v) for v in oracle.values()) >= 3
