"""The frame header's sums from the kernels' records, on the CPU.

* Prep's header sums record (``kernels/expand.py``: the visible count, the
  visible rect total and the row demand) from the plain prep in every mode
  -- mono with ``count_rows`` on and off, "none", "stereo", "warped" and
  "band" -- against a numpy transcription of its terms and against the
  torch sums the frames' headers took before prep wrote them, at 255, 256
  and 257 gaussians (one prep block less one, one, one and one more), with
  every gaussian visible, every one culled, and a mix; rects at the 8x4
  window's edges (8 or 9 tiles wide, 4 or 5 tall) in every scene.  Under
  ``count_rows`` the row demand is the scan's total, which equals the
  summed terms where a visible gaussian's rect_h is at least 1, as the
  projections write it.
* Every renderer's entries on a fixed pose sequence: the header's
  ``visible_count``, ``total_instances`` and ``row_total`` equal the torch
  sums that the frames took before (over the projection's ``visible``, the
  tile counts, the rect words), recomputed here from the frame's own chain;
  ``slot_total`` and ``overflow`` equal the expand's; and every CPU frame
  counts ``header_sums_torch``, none ``header_sums_kernel``.

The card's versions of these checks (the CUDA prep's record bit-equal to
the plain one at 1M and at the garden's shapes; replayed headers equal to
eager ones) are in tests/test_torch_sort_keys.py and
tests/test_torch_graph_replay.py.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import config as C
from gsm_renderer_tpu_torch import mathlib as M
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
from gsm_renderer_tpu_torch.kernels import expand as KE
from gsm_renderer_tpu_torch.pipelines import common as PC
from gsm_renderer_tpu_torch.pipelines import depth_first as PD
from gsm_renderer_tpu_torch.stereo import (foveated_raster_tables,
                                           make_rate_maps)

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

SIZES = (255, 256, 257)
SCENES = ("none_culled", "all_culled", "mixed")
MODES = {
    "mono_rows": dict(count_rows=True),
    "mono_full": dict(),
    "none": dict(mode="none"),
    "stereo": dict(mode="stereo"),
    "warped": dict(mode="warped"),
}
#: the 1080p tile grid of the garden cells
TILES_X, TILES_Y = 120, 68
#: (rect_w, rect_h) at the 8x4 window's edges
EDGES = np.array([[8, 4], [9, 4], [8, 5], [9, 5], [1, 1], [12, 6]])


def built_inputs(n: int, scene: str, seed: int = 7):
    """(rect_word uint32, rect_h int32, culled bool, 8 word rows uint32) of
    ``n`` built gaussians on the 1080p tile grid: rects of 1-12 x 1-6
    tiles, a third of them at the window's edges (EDGES); ``scene`` culls
    none, all or a fifth of them (a culled gaussian's rect as the
    projection writes it: 1 x 1 at the origin).  The record words hold
    means inside each rect, f16 sigmas and random colours and opacities;
    the right eye's record sits 25 px left of the left one's."""
    rng = np.random.default_rng(seed + n)
    min_tx = rng.integers(0, TILES_X - 12, n)
    min_ty = rng.integers(0, TILES_Y - 6, n)
    rect_w = rng.integers(1, 13, n)
    rect_h = rng.integers(1, 7, n)
    edge = rng.random(n) < 1 / 3
    pick = EDGES[rng.integers(0, len(EDGES), n)]
    rect_w = np.where(edge, pick[:, 0], rect_w)
    rect_h = np.where(edge, pick[:, 1], rect_h)
    culled = {"none_culled": np.zeros(n, bool), "all_culled": np.ones(n, bool),
              "mixed": rng.random(n) < 0.2}[scene]
    min_tx, min_ty = np.where(culled, 0, min_tx), np.where(culled, 0, min_ty)
    rect_w, rect_h = np.where(culled, 1, rect_w), np.where(culled, 1, rect_h)
    rect_word = (min_tx | (min_ty << 10) | (rect_w << 20)
                 | np.where(culled, KE.CULLED_BIT, 0)).astype(np.uint32)
    mx = (min_tx + np.minimum(rect_w, 8) * rng.random(n)) * 16.0
    my = (min_ty + np.minimum(rect_h, 4) * rng.random(n)) * 16.0

    def f16(x):
        return np.asarray(x, np.float16).view(np.uint16).astype(np.uint32)

    rows = []
    for shift in (0.0, -25.0):
        rows += [f16(mx + shift) | (f16(my) << 16),
                 rng.integers(0, 65536, n).astype(np.uint32)
                 | (f16(rng.uniform(0.5, 40.0, n)) << 16),
                 f16(rng.uniform(0.5, 40.0, n))
                 | (f16(rng.uniform(0.5, 30.0, n)) << 16),
                 rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)]
    rows[7] = rows[3]
    return rect_word, rect_h.astype(np.int32), culled, rows


def i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def wrap32(v) -> int:
    """An integer as the int32 that a sum cut to 32 bits gives."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def numpy_sums(visible, rect_w, rect_h):
    """The record's three sums of the terms (csrc/binning.cu's
    header_terms), transcribed in numpy."""
    rw, rh = rect_w.astype(np.int64), rect_h.astype(np.int64)
    oversized = visible & ((rw > KE.MASK_W) | (rh > KE.MASK_H))
    return [wrap32(visible.sum()), wrap32((rw * rh)[visible].sum()),
            wrap32(np.where(oversized, rh, 1).sum())]


def old_header_sums(rect_word, rect_h, visible):
    """The torch sums the frames' headers took before prep wrote them:
    ``visible.sum()``, the visible rect total, the row demand."""
    rw = M.u32(rect_word)
    rect_w = (rw >> 20) & 0x3FF
    oversized = ((rw & KE.CULLED_BIT) == 0) & ((rect_w > KE.MASK_W)
                                               | (rect_h > KE.MASK_H))
    return [int(visible.sum().to(torch.int32)),
            int(torch.where(visible, rect_w * rect_h, 0).sum().to(
                torch.int32)),
            int(torch.where(oversized, rect_h, 1).sum().to(torch.int32))]


def warped_bounds():
    """The (2, 128) bounds table of the 1080p foveated target."""
    return torch.from_numpy(foveated_raster_tables(make_rate_maps(
        1920, 1080, min_rate=0.4, radius=0.3))["bounds"])


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_prep_sums_are_the_header_sums(mode, n, scene):
    rect_word, rect_h, culled, rows = built_inputs(n, scene)
    kw = dict(MODES[mode])
    if mode == "warped":
        kw["warped_bounds"] = warped_bounds()
    words = [i32(w) for w in (rows[:4] if mode in ("mono_rows", "mono_full",
                                                   "none") else rows)]
    offsets, _rect, _mask, sums = KE.binning_prep_plain(
        i32(rect_word), i32(rect_h), words, **kw)
    assert sums.dtype == torch.int32 and sums.shape == (3,)
    visible = ~culled
    rect_w = (rect_word >> 20) & 0x3FF
    want = numpy_sums(visible, rect_w, rect_h)
    assert sums.tolist() == want
    assert sums.tolist() == old_header_sums(
        i32(rect_word), i32(rect_h), torch.from_numpy(visible))
    if kw.get("count_rows"):
        assert int(sums[2]) == int(offsets[-1])
    if scene == "all_culled":
        assert sums.tolist() == [0, 0, n]
    assert dict(zip(KE.HEADER_SUMS, sums.tolist()))["visible"] == want[0]


def test_plain_sums_wrap_as_int32_sums():
    """Rect totals past 2^32 wrap as the int64 torch sum cut to int32
    does: the record's arithmetic is modulo 2^32."""
    n = 257
    rect_word, _rh, culled, rows = built_inputs(n, "none_culled")
    rect_h = np.full(n, 1 << 22, np.int32)
    _off, _rect, _mask, sums = KE.binning_prep_plain(
        i32(rect_word), i32(rect_h), [i32(w) for w in rows[:4]], mode="none")
    want = numpy_sums(~culled, (rect_word >> 20) & 0x3FF, rect_h)
    assert sum(((rect_word >> 20) & 0x3FF).astype(np.int64)) << 22 > 1 << 32
    assert sums.tolist() == want


def band_planes(n: int, scene: str):
    """The gathered planes of a band frame from the built gaussians: the
    rect word, the rect rows (min_ty | max_ty << 10), the raw depth key
    (0xFFFFFFFF where culled) and a random 8x4 mask."""
    rect_word, rect_h, culled, _rows = built_inputs(n, scene)
    rng = np.random.default_rng(n)
    min_ty = (rect_word >> 10) & 0x3FF
    rows = (min_ty | ((min_ty + rect_h - 1) << 10)).astype(np.uint32)
    dkey = np.where(culled, 0xFFFFFFFF,
                    rng.integers(0, 1 << 31, n)).astype(np.uint32)
    mask = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return rect_word, rows, dkey, mask, culled


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("n", SIZES)
def test_plain_band_sums_are_the_band_clamps(n, scene):
    """Mode band's record: the same terms of each rect clamped to the
    band's tile rows [20, 40), visible where the gaussian is and has a row
    in the band."""
    rect_word, rows, dkey, mask, culled = band_planes(n, scene)
    band0, band1 = 20, 40
    *_tables, sums = KE.binning_prep_band_plain(
        i32(rect_word), i32(rows), i32(dkey), i32(mask), band0=band0,
        band1=band1)
    rows = rows.astype(np.int64)
    min_ty, max_ty = rows & 0x3FF, (rows >> 10) & 0x3FF
    in_band = np.clip(np.minimum(max_ty, band1 - 1)
                      - np.maximum(min_ty, band0) + 1, 0, None)
    visible = ~culled & (in_band > 0)
    assert sums.tolist() == numpy_sums(visible, (rect_word >> 20) & 0x3FF,
                                       in_band)


# -- every renderer's header -----------------------------------------------------

W, H, N = 192, 128, 3000
FOV = dict(min_rate=0.4, radius=0.3)
#: (renderer, entry, config); the last two run the frame functions with a
#: per-tile clamp
CASES = {
    "df.rows": ("DepthFirstRenderer", "render", dict(row_expand=True)),
    "df.rows_off": ("DepthFirstRenderer", "render", dict(row_expand=False)),
    "df.d16": ("DepthFirstRenderer", "render",
               dict(depth_sort_key_precision=T.DepthSortKeyPrecision.BITS16)),
    "df.stereo": ("DepthFirstRenderer", "render_stereo", {}),
    "df.foveated": ("DepthFirstRenderer", "render_stereo_foveated", {}),
    "df.compress": ("DepthFirstRenderer", "render_stereo_foveated_compress",
                    {}),
    "hw.mono": ("HardwareRenderer", "render", {}),
    "hw.stereo": ("HardwareRenderer", "render_stereo", {}),
    "hw.foveated": ("HardwareRenderer", "render_stereo_foveated", {}),
    "hw.compress": ("HardwareRenderer", "render_stereo_foveated_compress",
                    {}),
    "global": ("GlobalRenderer", "render", {}),
    "local": ("LocalRenderer", "render", {}),
    "local.clamped": ("LocalRenderer", "render", {}),
    "df.max_per_tile": (None, "depth_first_frame", {}),
}


@pytest.fixture(scope="module")
def gaussians():
    return generate_visible_gaussians(N, sh_degree=1, seed=5,
                                      scale_range=(0.01, 0.5)).to_input(
                                          device="cpu")


@pytest.fixture
def chain(monkeypatch):
    """The last frame's chain: the projection (mono, or the dual-eye one),
    the foveated re-binned rect counts, the tile counts the blend read and
    the expand's slot total and overflow."""
    rec = {}

    def wrap(mod, name, key, pick=lambda out: out):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            rec[key] = pick(out)
            return out

        monkeypatch.setattr(mod, name, wrapped)

    wrap(PC, "project_and_cull_packed", "proj")
    wrap(PD, "stereo_project_and_cull_packed", "proj")
    wrap(PD, "foveated_rects", "rect_count", lambda out: out[2])
    wrap(PC, "tile_ranges", "counts", lambda out: out[1])
    wrap(PC, "expand_slots", "expand", lambda out: out[-2:])
    wrap(PC, "row_expand", "row_overflow", lambda out: out[-1])
    return rec


def camera(k):
    """Pose k of a sequence that turns and dollies the default camera."""
    a = 0.06 * k
    view = np.array([[np.cos(a), 0, np.sin(a), 0], [0, 1, 0, 0],
                     [-np.sin(a), 0, np.cos(a), -0.2 * k], [0, 0, 0, 1]],
                    np.float32)
    return T.make_camera(W, H, view_matrix=view, far=20.0)


def render(case, gi, k, monkeypatch):
    cls, entry, config = CASES[case]
    cam = camera(k)
    if entry == "depth_first_frame":
        return PD.depth_first_frame(
            gi, cam.view_matrix, cam.projection_matrix, cam.position,
            width=W, height=H, capacity=1 << 18, sh_degree=1,
            alpha_threshold=0.005, total_ink_threshold=2.0, near_plane=0.1,
            far_plane=20.0, input_is_srgb=False, max_per_tile=4)
    if case == "local.clamped":
        monkeypatch.setattr(C, "LOCAL_MAX_PER_TILE", 6)
    r = getattr(T, cls)(T.RendererConfig(sh_degree=1, max_width=W,
                                         max_height=H, **config),
                        device="cpu")
    if entry == "render":
        return r.render(gi, cam, W, H)
    stereo = T.make_side_by_side_stereo(cam)
    if entry == "render_stereo":
        return r.render_stereo(gi, stereo, W, H)
    return getattr(r, entry)(gi, stereo, make_rate_maps(W, H, **FOV))


@pytest.mark.parametrize("case", list(CASES))
def test_renderer_headers_are_the_torch_sums(case, gaussians, chain,
                                             monkeypatch):
    cls, entry, _config = CASES[case]
    kind = ("foveated" if entry == "render_stereo_foveated"
            else "stereo" if "stereo" in entry else "mono")
    clamped = case in ("local.clamped", "df.max_per_tile")
    rows = kind == "mono" and cls in ("DepthFirstRenderer", None)
    seen_clamp = False
    c0 = P.counters()
    for k in range(2):
        h = render(case, gaussians, k, monkeypatch).header
        proj = chain["proj"]
        old = old_header_sums(proj.rect_word, proj.rect_h, proj.visible)
        assert int(h.visible_count) == old[0]
        if kind == "foveated":
            total = int(chain["rect_count"].sum().to(torch.int32))
        elif kind == "stereo" or case == "df.max_per_tile":
            total = old[1]
        else:
            total = int(chain["counts"].sum().to(torch.int32))
        assert int(h.total_instances) == total
        if rows:
            assert int(h.row_total) == old[2]
        else:
            assert h.row_total is None
        slot_total, overflow = chain["expand"]
        if "row_overflow" in chain:
            overflow = torch.maximum(overflow, chain["row_overflow"])
        assert int(h.slot_total) == int(slot_total)
        assert int(h.overflow) == int(overflow)
        for f in ("visible_count", "total_instances", "overflow",
                  "slot_total"):
            value = getattr(h, f)
            assert value.dtype == torch.int32 and value.shape == ()
        seen_clamp |= (int(chain["counts"].max()) <= 6
                       and int(h.slot_total) > int(chain["counts"].sum()))
        chain.clear()
    moved = {k: v - c0[k] for k, v in P.counters().items()
             if k.startswith("header_sums")}
    assert moved == {"header_sums_kernel": 0, "header_sums_torch": 2}
    assert seen_clamp == clamped
