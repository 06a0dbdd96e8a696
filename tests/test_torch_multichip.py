"""Band-sharded multi-device rendering of gsm_renderer_tpu_torch
(``parallel/multichip.py``) on the CPU against the JAX package.

* Frames.  A 4-rank gloo world (spawned processes, a file store) renders
  tests/test_multichip.py's hot-strip scene (n = 2003, not a multiple of
  4; 128x256) with the KeyPlan and the stable fallback (``use_keyplan``),
  with equal bands and with bands balanced from the row histogram, at
  32x16 tiles (the Global renderer's; KeyPlan, equal bands), at 24x24
  tiles (a side that is not a power of two; KeyPlan, equal bands), at
  96x64 tiles (6144 pixels a tile, the blend's large-tile path: one tile
  row a rank), and at a capacity of 2048 slots a band.  One JAX
  subprocess renders the same frames with ``build_sharded_depth_first(...,
  use_xla_blend=False, interpret=True)`` on a 4-device CPU mesh (set up as
  tests/test_multichip.py does).  Colour within COLOR_TOL (2e-4, that
  file's own bound on the sharded frame) and depth within DEPTH_TOL (the
  same times the far plane) of JAX's: the projections' theta may differ
  by a u16 unit (contracted FMAs); this scene shows 2.1e-6 and 8.0e-6.
  Overflow flags equal, 1 on every rank at the tiny capacity.
* Against the port's own mono frame.  With the blend's tile-level early
  exit off, every band frame is the mono frame bit for bit.  With it on,
  a tile whose pixels all saturate stops at the end of a 256-record batch
  aligned to 128-record blocks of its band's sorted list, not of the mono
  list, so colour differs by less than the exit threshold (1/255) and
  depth by less than it times the far plane.  A world of one is the mono
  frame bit for bit.  At 32x16, 24x24 and 96x64 the mono frame is
  ``depth_first_frame`` at that tile (the renderer's tile is 16x16).
* Kernel modes.  Prep "band" against a NumPy transcription of the JAX
  band clamp (``gsm_renderer_tpu/parallel/multichip.py:245-283`` and
  ``binning_inputs`` with its ``mask_override``); the expand with a tile
  row offset and the band sub-mask against ``expand_slots_pallas(
  tile_row_offset=, tile_mask=, interpret=True)`` (KeyPlan and plain tile
  key), exactly; the blend with a tile row offset against
  ``blend_tiles_pallas(tile_row_offset=, interpret=True)`` (same records
  and exit points: float32-close); each also on 32x16 tiles.
* Helpers.  ``row_instance_histogram``, ``balance_band_starts`` and
  ``pad_gaussian_input`` equal JAX's; the dry-run twin passes.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gsm_renderer_tpu.kernels import blend as JK
from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.parallel import multichip as JM
from gsm_renderer_tpu.types import GaussianInput as JaxInput

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch.kernels import blend as TK
from gsm_renderer_tpu_torch.kernels import expand as TE
from gsm_renderer_tpu_torch.ops import binning as TB
from gsm_renderer_tpu_torch.parallel import multichip as TM
from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import multichip_ranks as R  # noqa: E402

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N, RANKS = 128, 256, 2003, 4
CAP = 65536          # a band's capacity that no band of the scene exceeds
TINY_CAP = 2048      # every band overflows
# tests/test_multichip.py's bound on the colour; depth: that bound times
# the far plane, every record lying before it
COLOR_TOL = 2e-4
DEPTH_TOL = COLOR_TOL * R.FAR
SENTINEL = 0xFFFFFFFF

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=%(ranks)d"
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == %(ranks)d, jax.devices()
import numpy as np
from jax.sharding import Mesh
import gsm_renderer_tpu as G
from gsm_renderer_tpu.io.scene import generate_visible_gaussians
from gsm_renderer_tpu.parallel.multichip import (
    balance_band_starts, build_sharded_depth_first, row_instance_histogram,
    shard_gaussian_input)

mesh = Mesh(np.array(jax.devices()), ("dp",))
w, h, n = %(w)d, %(h)d, %(n)d
ds = generate_visible_gaussians(n, sh_degree=1, scale_range=(0.12, 0.28))
ds.positions[:, 1] = 0.04 * (ds.positions[:, 1] / 1.5) + 0.55
view, proj, center = G.make_camera(w, h, far=20.0).astuple_jax()
gi = shard_gaussian_input(ds.to_input(), mesh)
hist = row_instance_histogram(ds.to_input(), view, proj, center, width=w,
                              height=h, sh_degree=1, near_plane=0.1,
                              far_plane=20.0)
starts = balance_band_starts(hist, %(ranks)d)
out = dict(hist=np.asarray(hist), starts=np.asarray(starts))
for name, kw in (("keyplan", dict(capacity_per_device=%(cap)d)),
                 ("stable", dict(capacity_per_device=%(cap)d,
                                 use_keyplan=False)),
                 ("balanced", dict(capacity_per_device=%(cap)d,
                                   band_starts=starts)),
                 ("tiny", dict(capacity_per_device=%(tiny)d)),
                 ("keyplan32", dict(capacity_per_device=%(cap)d, tile_w=32,
                                    tile_h=16)),
                 ("keyplan24", dict(capacity_per_device=%(cap)d, tile_w=24,
                                    tile_h=24)),
                 ("keyplan96", dict(capacity_per_device=%(cap)d, tile_w=96,
                                    tile_h=64))):
    render = build_sharded_depth_first(
        mesh, width=w, height=h, n_total=n, sh_degree=1, near_plane=0.1,
        far_plane=20.0, use_xla_blend=False, interpret=True, **kw)
    color, depth, overflow = render(gi, view, proj, center)
    out[name + "_color"] = np.asarray(color)
    out[name + "_depth"] = np.asarray(depth)
    out[name + "_overflow"] = np.asarray(overflow)
np.savez(%(path)r, **out)
print("JAX_FRAMES_OK")
"""

FRAMES = ("keyplan", "stable", "balanced", "keyplan32", "keyplan24",
          "keyplan96")
#: each frame's tile (tile_w, tile_h), 16x16 where not named; 96x64 gives
#: each of the 4 ranks one tile row of 6144-pixel tiles
TILES = dict(keyplan32=(32, 16), keyplan24=(24, 24), keyplan96=(96, 64))


def scene_input():
    return R.hot_strip_scene(N).to_input(device="cpu")


def camera():
    return T.make_camera(W, H, far=R.FAR)


def hist_kw():
    return dict(width=W, height=H, sh_degree=1, near_plane=R.NEAR,
                far_plane=R.FAR)


def mono_frame_at(cam, tile_w, tile_h):
    """The port's mono DepthFirst chain at tile_w x tile_h tiles with a
    KeyPlan, rows off (``depth_first_frame``; the renderer's tile is
    16x16)."""
    return depth_first_frame(
        scene_input(), cam.view_matrix, cam.projection_matrix, cam.position,
        width=W, height=H, capacity=131072, sh_degree=1,
        alpha_threshold=0.005, total_ink_threshold=2.0, near_plane=R.NEAR,
        far_plane=R.FAR, input_is_srgb=False, tile_w=tile_w, tile_h=tile_h)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The JAX subprocess's frames (started first, run alongside) and the
    port's 4-rank world's, plus the port's mono frames."""
    path = str(tmp_path_factory.mktemp("multichip") / "jax_frames.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT % dict(
            repo=REPO, ranks=RANKS, w=W, h=H, n=N, cap=CAP, tiny=TINY_CAP,
            path=path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        cam = camera()
        hist = TM.row_instance_histogram(
            scene_input(), cam.view_matrix, cam.projection_matrix,
            cam.position, **hist_kw())
        starts = TM.balance_band_starts(hist, RANKS)
        kws = dict(keyplan=dict(capacity_per_device=CAP),
                   stable=dict(capacity_per_device=CAP, use_keyplan=False),
                   balanced=dict(capacity_per_device=CAP, band_starts=starts),
                   tiny=dict(capacity_per_device=TINY_CAP),
                   keyplan32=dict(capacity_per_device=CAP, tile_w=32),
                   keyplan24=dict(capacity_per_device=CAP, tile_w=24,
                                  tile_h=24),
                   keyplan96=dict(capacity_per_device=CAP, tile_w=96,
                                  tile_h=64))
        names = list(kws) + [f"{k}_no_exit" for k in FRAMES]
        world = TM.run_ranks(
            R.render_frames, RANKS, W, H, N,
            [kws[k] for k in kws] + [dict(kws[k], early_exit=False)
                                     for k in FRAMES])
        one = TM.run_ranks(R.render_frames, 1, W, H, N,
                           [kws["keyplan"], kws["keyplan32"]])
        r = T.DepthFirstRenderer(T.RendererConfig(
            sh_degree=1, row_expand=False, max_instances=131072), device="cpu")
        mono = {}
        exit_t = TK.MIN_TRANSMITTANCE
        for label, t in (("exit", exit_t), ("no_exit", 0.0)):
            TK.MIN_TRANSMITTANCE = t
            try:
                mono[label] = r.render(scene_input(), cam, W, H)
                for tile in TILES.values():
                    mono[label + str(tile[0])] = mono_frame_at(cam, *tile)
            finally:
                TK.MIN_TRANSMITTANCE = exit_t
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    assert "JAX_FRAMES_OK" in stdout, stdout
    port = {name: [rank[k] for rank in world] for k, name in enumerate(names)}
    return dict(jax=dict(np.load(path)), port=port, one=one[0][0],
                one32=one[0][1], mono=mono, hist=hist, starts=starts)


@pytest.mark.parametrize("name", FRAMES)
def test_band_frame_matches_jax(frames, name):
    ref, got = frames["jax"], frames["port"][name]
    assert [g["overflow"] for g in got] == [0] * RANKS
    assert int(ref[name + "_overflow"]) == 0
    color, depth = got[0]["color"], got[0]["depth"]
    assert color.shape == (H, W, 4) and depth.shape == (H, W)
    np.testing.assert_allclose(color, ref[name + "_color"], atol=COLOR_TOL)
    np.testing.assert_allclose(depth, ref[name + "_depth"], atol=DEPTH_TOL)
    assert float(color[..., :3].max()) > 0.05


def test_tiny_capacity_overflows_on_every_rank(frames):
    got = frames["port"]["tiny"]
    assert [g["overflow"] for g in got] == [1] * RANKS
    assert int(frames["jax"]["tiny_overflow"]) == 1
    assert np.isfinite(got[0]["color"]).all()


@pytest.mark.parametrize("name", FRAMES)
def test_band_frame_is_the_mono_frame(frames, name):
    """Bit-equal with the early exit off; with it on, within the exit
    threshold (see the module docstring)."""
    tile = str(TILES[name][0]) if name in TILES else ""
    mono = frames["mono"]["exit" + tile]
    no_exit = frames["mono"]["no_exit" + tile]
    got = frames["port"][f"{name}_no_exit"][0]
    np.testing.assert_array_equal(got["color"], no_exit.color.numpy())
    np.testing.assert_array_equal(got["depth"], no_exit.depth.numpy())
    got = frames["port"][name][0]
    np.testing.assert_allclose(got["color"], mono.color.numpy(), rtol=0,
                               atol=TK.MIN_TRANSMITTANCE)
    # every record lies before the far plane
    np.testing.assert_allclose(got["depth"], mono.depth.numpy(), rtol=0,
                               atol=TK.MIN_TRANSMITTANCE * R.FAR)
    assert int(mono.header.overflow) == 0


def test_world_of_one_is_the_mono_frame(frames):
    mono, one = frames["mono"]["exit"], frames["one"]
    assert one["overflow"] == 0 and one["band_starts"] == (0, H // 16)
    np.testing.assert_array_equal(one["color"], mono.color.numpy())
    np.testing.assert_array_equal(one["depth"], mono.depth.numpy())


def test_world_of_one_at_32x16_is_the_mono_frame(frames):
    mono, one = frames["mono"]["exit32"], frames["one32"]
    assert one["overflow"] == 0 and one["band_starts"] == (0, H // 16)
    np.testing.assert_array_equal(one["color"], mono.color.numpy())
    np.testing.assert_array_equal(one["depth"], mono.depth.numpy())


def test_band_rows_and_starts(frames):
    """Each rank returns its band's rows; the balanced starts are JAX's."""
    eq = [r["rows"] for r in frames["port"]["keyplan"]]
    assert eq == [64] * RANKS
    bal = frames["port"]["balanced"]
    starts = bal[0]["band_starts"]
    assert [r["rows"] for r in bal] == [16 * (b1 - b0) for b0, b1
                                       in zip(starts, starts[1:])]
    assert starts == tuple(int(s) for s in frames["jax"]["starts"])


def test_row_histogram_matches_jax(frames):
    np.testing.assert_array_equal(frames["hist"], frames["jax"]["hist"])
    assert frames["starts"] == TM.balance_band_starts(frames["jax"]["hist"],
                                                      RANKS)
    # balancing moves load out of the hot equal-split band
    hist = frames["hist"]

    def loads(bs):
        return [int(hist[b0:b1].sum()) for b0, b1 in zip(bs, bs[1:])]
    assert max(loads(frames["starts"])) < max(loads((0, 4, 8, 12, 16)))


@pytest.mark.parametrize("hist,n_dev", [
    (np.arange(16), 4), (np.r_[np.zeros(10), 1000, np.zeros(5)], 4),
    (np.ones(7), 7), (np.random.default_rng(3).integers(0, 50, 68), 8)])
def test_balance_band_starts_matches_jax(hist, n_dev):
    assert TM.balance_band_starts(hist, n_dev) == JM.balance_band_starts(hist,
                                                                         n_dev)


def test_pad_gaussian_input_matches_jax():
    ds = R.hot_strip_scene(N)
    gi = TM.pad_gaussian_input(ds.to_input(device="cpu"), RANKS)
    jgi = JM.pad_gaussian_input(
        JaxInput(positions=jnp.asarray(ds.positions),
                 scales=jnp.asarray(ds.scales),
                 rotations=jnp.asarray(ds.rotations),
                 opacities=jnp.asarray(ds.opacities),
                 harmonics=jnp.asarray(gi.harmonics[..., :N].numpy())), RANKS)
    assert gi.count == 2004
    for name in ("positions", "scales", "rotations", "opacities",
                 "harmonics"):
        np.testing.assert_array_equal(getattr(gi, name).numpy(),
                                      np.asarray(getattr(jgi, name)))
    shards = [TM.shard_gaussian_input(ds.to_input(device="cpu"), r, RANKS)
              for r in range(RANKS)]
    np.testing.assert_array_equal(
        torch.cat([s.positions for s in shards]).numpy(), gi.positions.numpy())


def test_dryrun_multichip_twin():
    TM.dryrun_multichip(2, device="cpu")


def test_band_frame_refuses_other_tiles(tmp_path):
    """Tiles of 1 to 4096 pixels a side render (the frames above, the
    24x24 and 96x64 band frames against JAX's, and
    tests/test_torch_tiles*.py): 65x16 and 16x128 build in a gloo world of
    one; other sides raise before the frame touches its process group."""
    for tile_w, tile_h in ((0, 12), (16, 4097)):
        with pytest.raises(ValueError, match="tile sides of 1 to 4096"):
            TM.build_sharded_depth_first(width=W, height=H, n_total=N,
                                         tile_w=tile_w, tile_h=tile_h,
                                         device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        for tile_w, tile_h in ((65, 16), (16, 128)):
            render = TM.build_sharded_depth_first(
                width=W, height=H, n_total=N, tile_w=tile_w, tile_h=tile_h,
                device="cpu")
            assert render.band_starts == (0, -(-H // tile_h))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError):
        TM.resolve_band_starts(16, 4, (0, 4, 4, 12, 16))


# ---------------------------------------------------------------------------
# Kernel modes on the gathered planes of the whole scene
# ---------------------------------------------------------------------------

def project_block(tile_w):
    cam = camera()
    return TM.project_block(
        scene_input(), cam.view_matrix, cam.projection_matrix, cam.position,
        tile_w=tile_w, tile_h=16, alpha_threshold=0.005,
        total_ink_threshold=2.0, input_is_srgb=False, **hist_kw())


@pytest.fixture(scope="module")
def block():
    return project_block(16)


@pytest.fixture(scope="module")
def block32():
    """The gathered planes at 32x16 tiles (4 tile columns)."""
    return project_block(32)


def numpy_band_clamp(block, band0, band1, plan):
    """NumPy transcription of the JAX band clamp (multichip.py:245-283) and
    of binning_inputs with its mask_override, on uint32 planes."""
    g = np.asarray(block).astype(np.int64) & 0xFFFFFFFF
    rect_word, rect_rows, dk, mask_g = g[4], g[5], g[6], g[7]
    visible_g = dk != SENTINEL
    rect_w_g = (rect_word >> 20) & 0x3FF
    min_ty_g = rect_rows & 0x3FF
    max_ty_g = (rect_rows >> 10) & 0x3FF
    bty0 = np.maximum(min_ty_g, band0)
    bty1 = np.minimum(max_ty_g, band1 - 1)
    rows_in_band = np.maximum(bty1 - bty0 + 1, 0)
    visible_here = visible_g & (rows_in_band > 0)
    counts = np.where(visible_here, rect_w_g * rows_in_band, 0)
    rect_h_full = max_ty_g - min_ty_g + 1
    shift = np.clip(bty0 - min_ty_g, 0, 3)
    sub_mask = mask_g >> (8 * shift)
    rows_bits = np.where(rows_in_band >= 4, SENTINEL,
                         (1 << (8 * np.clip(rows_in_band, 0, 3))) - 1)
    sub_mask = sub_mask & rows_bits
    eligible = visible_here & (rect_w_g <= 8) & (rect_h_full <= 4)
    sub_cnt = np.array([bin(int(m)).count("1") for m in sub_mask])
    counts = np.where(eligible, sub_cnt, counts)
    visible_here = visible_here & (~eligible | (sub_cnt > 0))
    # binning_inputs
    min_tx_g = rect_word & 0x3FF
    rect_word2 = min_tx_g | ((bty0 - band0) << 10) | (rect_w_g << 20)
    rect_word2 = np.where(eligible, rect_word2 | (1 << 31), rect_word2)
    rect_word2 = np.where(visible_here, rect_word2, rect_word2 | (1 << 30))
    counts = np.maximum(counts, 1)
    dsw = dk if plan is None else np.minimum(
        np.maximum(dk, plan.near_key) - plan.near_key, plan.span)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return offsets, rect_word2, sub_mask, dsw


BANDS = [(0, 4), (8, 12), (5, 8), (12, 16), (7, 9)]


@pytest.mark.parametrize("band0,band1", BANDS)
@pytest.mark.parametrize("keyplan", [True, False])
def test_prep_band_matches_numpy_transcription(block, band0, band1, keyplan):
    check_prep_band(block, band0, band1, keyplan)


@pytest.mark.parametrize("band0,band1", [(0, 4), (7, 9)])
def test_prep_band_at_32x16_matches_numpy_transcription(block32, band0,
                                                         band1):
    check_prep_band(block32, band0, band1, True)


def check_prep_band(block, band0, band1, keyplan):
    plan = (TB.make_key_plan(8 * 4, RANKS * 501, near_plane=R.NEAR,
                             far_plane=R.FAR) if keyplan else None)
    got = TE.binning_prep_band(block[4], block[5], block[6], block[7],
                               band0=band0, band1=band1, key_plan=plan)
    want = numpy_band_clamp(block, band0, band1, plan)
    for k, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64)
                                      & 0xFFFFFFFF, w, err_msg=f"output {k}")
    assert int(got[0][-1]) > N  # every gaussian owns a slot, some more


def band_tables(block, band0, band1, plan):
    return TE.binning_prep_band(block[4], block[5], block[6], block[7],
                                band0=band0, band1=band1, key_plan=plan)


@pytest.mark.parametrize("band0,band1", [(8, 12), (12, 16)])
@pytest.mark.parametrize("keyplan", [True, False])
def test_expand_with_row_offset_matches_pallas(block, band0, band1, keyplan):
    check_expand_with_row_offset(block, band0, band1, keyplan, tile_w=16)


@pytest.mark.parametrize("keyplan", [True, False])
def test_expand_32x16_with_row_offset_matches_pallas(block32, keyplan):
    check_expand_with_row_offset(block32, 8, 12, keyplan, tile_w=32)


def check_expand_with_row_offset(block, band0, band1, keyplan, tile_w):
    bands = band1 - band0
    tiles_x = W // tile_w
    plan = (TB.make_key_plan(tiles_x * bands, N, near_plane=R.NEAR,
                             far_plane=R.FAR) if keyplan else None)
    offsets, rect, mask, dsw = band_tables(block, band0, band1, plan)
    words = list(block[:4])
    capacity = (int(offsets[-1]) // 4096 + 1) * 4096
    *keys, total, overflow = TE.expand_slots(
        offsets, rect, mask, dsw, words, capacity=capacity, tiles_x=tiles_x,
        key_plan=plan, tile_row_offset=band0, tile_w=tile_w)
    u = lambda t: jnp.asarray(t.numpy().view(np.uint32))  # noqa: E731
    outs = JE.expand_slots_pallas(
        jnp.asarray(np.diff(offsets.numpy())), u(rect),
        [u(dsw)] + [u(w) for w in words], capacity=capacity, tiles_x=tiles_x,
        exact_test=True, tile_w=tile_w, tile_row_offset=jnp.int32(band0),
        tile_mask=u(mask),
        key_plan=None if plan is None else plan.kernel_tuple, interpret=True)
    ref_key, ref_d = (np.asarray(o).astype(np.int64) for o in outs[:2])
    k1, k2 = (k.numpy().astype(np.int64) & 0xFFFFFFFF for k in keys[:2])
    live = ref_key != SENTINEL
    np.testing.assert_array_equal(k1, ref_key)
    if plan is None:
        # JAX carries the depth word and zeros at dead slots; the entry
        # plane's words are the ones JAX carries
        np.testing.assert_array_equal(k2[live], ref_d[live])
        g = keys[2].numpy()[live]
        for k, w in enumerate(words):
            np.testing.assert_array_equal(
                w.numpy().view(np.uint32)[g], np.asarray(outs[2 + k])[live])
    else:
        np.testing.assert_array_equal(k2, ref_d)
    assert int(total) == int(outs[-2]) and int(overflow) == int(outs[-1]) == 0
    assert live.sum() > 100


def f16b(x):
    return np.asarray(x, np.float16).view(np.uint16).astype(np.uint32)


@pytest.mark.parametrize("row_offset", [0, 5])
def test_blend_with_row_offset_matches_pallas(row_offset):
    """Records around the band's tile rows [row_offset, row_offset + 2);
    half the tiles saturate mid-span, so the exit points count."""
    check_blend_with_row_offset(row_offset, tile_w=16)


def test_blend_32x16_with_row_offset_matches_pallas():
    check_blend_with_row_offset(5, tile_w=32)


def check_blend_with_row_offset(row_offset, tile_w):
    rng = np.random.default_rng(33)
    tiles_x, tiles_y, per = 3, 2, 300
    n_live = tiles_x * tiles_y * per
    cap = -(-(n_live + 200) // 128) * 128
    mx = rng.uniform(0, tiles_x * tile_w, n_live)
    my = rng.uniform(row_offset * 16, (row_offset + tiles_y) * 16, n_live)
    s1, s2 = rng.uniform(1.0, 16.0, (2, n_live))
    th = rng.uniform(0, np.pi, n_live)
    opq = rng.integers(20, 256, n_live).astype(np.uint32)
    col = rng.integers(0, 256, (n_live, 3)).astype(np.uint32)
    dep = rng.uniform(1.0, 12.0, n_live)
    w = [np.zeros(cap, np.uint32) for _ in range(4)]
    w[0][:n_live] = f16b(mx) | (f16b(my) << 16)
    w[1][:n_live] = (np.round(th / np.pi * 65535.0).astype(np.uint32)
                     | (f16b(s1) << 16))
    w[2][:n_live] = f16b(s2) | (f16b(dep) << 16)
    w[3][:n_live] = (col[:, 0] | (col[:, 1] << 8) | (col[:, 2] << 16)
                     | (opq << 24))
    starts = (np.arange(tiles_x * tiles_y) * per).astype(np.int32)
    counts = np.full(tiles_x * tiles_y, per, np.int32)
    ref_color, ref_depth = (np.asarray(x) for x in JK.blend_tiles_pallas(
        JK.build_words_table([jnp.asarray(x) for x in w], cap),
        jnp.asarray(starts), jnp.asarray(counts), tiles_x=tiles_x,
        tiles_y=tiles_y, tile_w=tile_w, tile_row_offset=jnp.int32(row_offset),
        interpret=True))
    color, depth = TK.blend_tiles_plain(
        torch.arange(cap, dtype=torch.int64),
        torch.from_numpy(np.stack(w).view(np.int32).copy()), 32,
        torch.from_numpy(starts), torch.from_numpy(counts), tiles_x=tiles_x,
        tile_w=tile_w, tile_row_offset=row_offset)
    np.testing.assert_allclose(color.numpy(), ref_color, atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), ref_depth, atol=1e-4)
    assert float(color[..., 3].mean()) > 0.5
    if row_offset:
        # the records lie in the band's rows: without the offset the tiles
        # would see (almost) nothing of them
        c0, _ = TK.blend_tiles_plain(
            torch.arange(cap, dtype=torch.int64),
            torch.from_numpy(np.stack(w).view(np.int32).copy()), 32,
            torch.from_numpy(starts), torch.from_numpy(counts),
            tiles_x=tiles_x, tile_w=tile_w)
        assert float(c0[..., 3].mean()) < 0.5 * float(color[..., 3].mean())
