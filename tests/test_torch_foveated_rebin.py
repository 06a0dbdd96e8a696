"""The foveated re-bin onto the physical tiles: the kernel
(``kernels/expand.py::foveated_rebin_cuda``, ``csrc/binning.cu``
``gsm_foveated_rebin``) and its plain version
(``pipelines/depth_first.py::foveated_packed``).

On the CPU: a NumPy float32 statement of the kernel's arithmetic (Horner in
float32, true divisions, floor and clamp; rect_h the re-binned rect's rows,
0 where not visible) equals the plain chain over random pixel bounds at
both rate maps of the benchmark (min_rate 0.4 and 0.15) and two tiles; the
wrapper refuses malformed operands before it launches.  On the card (marked
``card``): at the garden cell's shapes (5.8M gaussians, 1920x1080 eyes) the
kernel is bit-equal to the plain chain on the frames' own projections at
several head-sway poses and both rate maps, and the replayed foveated
garden frames are bit-equal to eager ones.  Imports no JAX, so that
``python -m pytest --noconftest tests/test_torch_foveated_rebin.py -m
card`` runs on a machine with a card and without JAX."""

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.kernels import expand as KE
from gsm_renderer_tpu_torch.kernels.project import StereoPackedProjection
from gsm_renderer_tpu_torch.pipelines import depth_first as PD
from gsm_renderer_tpu_torch.stereo import foveated_raster_tables

RATES = (0.4, 0.15)
F32 = np.float32


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def kernel_arithmetic(px_min, px_max, py_min, py_max, seen, fit, tiles_x,
                      tiles_y, tile_w, tile_h):
    """The kernel's re-bin in NumPy float32, as csrc/binning.cu states it:
    (rect word, rect_h, visible)."""
    def warp(row, v):
        t = (v - row[10]).astype(F32) / F32(row[11] - row[10])
        t = (t.astype(F32) * F32(2)).astype(F32) - F32(1)
        acc = np.full_like(v, row[0])
        for k in range(1, 10):
            acc = ((acc * t).astype(F32) + row[k]).astype(F32)
        return acc

    def tile(v, side, n):
        f = np.floor((v * F32(1.0 / side)).astype(F32))
        return np.clip(f.astype(np.int32), 0, n - 1)

    mx, my = fit[0][12], fit[1][12]
    min_tx = tile((warp(fit[0], px_min) - mx).astype(F32), tile_w, tiles_x)
    max_tx = tile((warp(fit[0], px_max) + mx).astype(F32), tile_w, tiles_x)
    min_ty = tile((warp(fit[1], py_min) - my).astype(F32), tile_h, tiles_y)
    max_ty = tile((warp(fit[1], py_max) + my).astype(F32), tile_h, tiles_y)
    vis = seen & (min_tx <= max_tx) & (min_ty <= max_ty)
    rect_w = np.where(seen & ~vis, 0, max_tx - min_tx + 1).astype(np.uint32)
    word = (min_tx.astype(np.uint32) | (min_ty.astype(np.uint32) << 10)
            | (rect_w << 20))
    word = np.where(seen, word, word | np.uint32(KE.CULLED_BIT))
    return (word.view(np.int32), np.where(vis, max_ty - min_ty + 1,
                                          0).astype(np.int32), vis)


def random_projection(width, height, n, seed):
    """A StereoPackedProjection's fields the re-bin reads: union pixel
    bounds within the display (0 where not seen), a tenth of them empty
    boxes and a hundredth reversed by 80 pixels (so that their re-binned
    rects come out empty)."""
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.uniform(-5, width + 5, n), 0, width).astype(F32)
    y0 = np.clip(rng.uniform(-5, height + 5, n), 0, height).astype(F32)
    x1 = np.minimum(x0 + rng.exponential(30, n), width).astype(F32)
    y1 = np.minimum(y0 + rng.exponential(30, n), height).astype(F32)
    x1[: n // 10] = x0[: n // 10]
    x0[: n // 100] = np.minimum(x1[: n // 100] + 80, width)
    seen = rng.random(n) < 0.7
    for a in (x0, x1, y0, y1):
        a[~seen] = 0.0
    t = torch.from_numpy
    zeros = torch.zeros(n, dtype=torch.int32)
    return StereoPackedProjection(rect_word=zeros, rect_h=zeros, dsw=zeros,
                                  words=[], visible=t(seen), px_min=t(x0),
                                  px_max=t(x1), py_min=t(y0), py_max=t(y1))


@pytest.mark.parametrize("tile", [(16, 16), (24, 12)])
@pytest.mark.parametrize("min_rate", RATES)
def test_kernel_arithmetic_is_the_plain_chain(min_rate, tile):
    target = T.make_rate_maps(1920, 1080, min_rate=min_rate, radius=0.3)
    fit = foveated_raster_tables(target, *tile)["inv_fit"]
    tiles_x = -(-target.render_width // tile[0])
    tiles_y = -(-target.render_height // tile[1])
    pp = random_projection(1920, 1080, 200_000, seed=int(min_rate * 100))
    got, _ = PD.foveated_packed(pp, fit, tiles_x=tiles_x, tiles_y=tiles_y,
                                tile_w=tile[0], tile_h=tile[1])
    word, rect_h, vis = kernel_arithmetic(
        *(t.numpy() for t in (pp.px_min, pp.px_max, pp.py_min, pp.py_max,
                              pp.visible)), fit, tiles_x, tiles_y, *tile)
    assert 0 < vis.sum() < pp.visible.sum()  # some empty re-binned rects
    np.testing.assert_array_equal(got.rect_word.numpy(), word)
    np.testing.assert_array_equal(got.rect_h.numpy(), rect_h)
    np.testing.assert_array_equal(got.visible.numpy(), vis)


@pytest.mark.parametrize("fault", ["fit", "dtype", "length"])
def test_wrapper_refuses_malformed_operands(fault):
    """The wrapper checks its operands before anything is launched."""
    n = 8
    bounds = [torch.zeros(n) for _ in range(4)]
    seen = torch.ones(n, dtype=torch.bool)
    fit = np.zeros((2, 13), np.float32)
    if fault == "fit":
        fit = np.zeros((2, 12), np.float32)
    elif fault == "dtype":
        bounds[1] = torch.zeros(n, dtype=torch.float64)
    else:
        bounds[3] = torch.zeros(n + 1)
    with pytest.raises(ValueError):
        KE.foveated_rebin_cuda(*bounds, seen, fit, tiles_x=4, tiles_y=3)


# -- on the card, at the garden cell's shapes -------------------------------------

CELL = "garden-foveated-1080p.head-sway"
SEED = 2 ** 31 + 11
POSES = (0, 45, 90, 135)


@pytest.fixture(scope="module")
def garden():
    """(cell, the 5.8M-gaussian GaussianInput on the card, the head-sway
    loop), or a skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsmbench.harness import cell as cell_mod, scene as scene_mod
    from gsmbench.harness import traffic

    cell = cell_mod.load(CELL)
    cfg = cell.config
    scene = scene_mod.make_scene(cfg["scene"], SEED, "cuda", torch.float16)
    loop = traffic.poses(cell.traffic, cfg["viewpoint"], SEED)
    return cell, T.GaussianInput(**scene), loop


def renderer(cell, min_rate, eager):
    import copy

    from gsmbench.run import renderer_config

    cfg = copy.deepcopy(cell.config)
    cfg["foveation"]["min_rate"] = min_rate
    r = T.DepthFirstRenderer(renderer_config(T, cfg), device="cuda")
    r._eager_frames = eager
    return cfg, r


@pytest.mark.card
@pytest.mark.parametrize("min_rate", RATES)
def test_card_kernel_is_the_plain_chain_at_garden_shapes(garden, monkeypatch,
                                                         min_rate):
    """Each eager garden frame's re-bin, kernel against the plain chain on
    the same projection: rect word, rect_h and visibility bit for bit."""
    cell, gi, loop = garden
    cfg, r = renderer(cell, min_rate, eager=True)
    frame = cell.entry().build(T, cfg, r, gi)
    checked = []
    rebin = PD.foveated_rebin

    def both(pp, inv_fit, **grid):
        got = rebin(pp, inv_fit, **grid)
        want, _ = PD.foveated_packed(pp, inv_fit, **grid)
        for f in ("rect_word", "rect_h", "visible"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        checked.append(int(want.visible.sum()))
        return got

    monkeypatch.setattr(PD, "foveated_rebin", both)
    c0 = P.counters()
    for k in POSES:
        frame(loop[k])
    torch.cuda.synchronize()
    assert len(checked) == len(POSES) and min(checked) > 100_000
    got = P.counters()
    assert got["rebin_kernel"] - c0["rebin_kernel"] == len(POSES)
    assert got["rebin_torch"] == c0["rebin_torch"]


@pytest.mark.card
def test_card_garden_replays_are_eager_frames(garden):
    """Replayed foveated garden frames at the cell's rate map equal eager
    frames at the same poses: colour, depth and header bit for bit."""
    cell, gi, loop = garden
    cfg, g = renderer(cell, 0.15, eager=False)
    _, e = renderer(cell, 0.15, eager=True)
    fg = cell.entry().build(T, cfg, g, gi)
    fe = cell.entry().build(T, cfg, e, gi)
    for k in range(3):  # eager, then the capture: both capacities lock in
        fg(loop[k])
        fe(loop[k])
    torch.cuda.synchronize()
    c0 = P.counters()
    for k in POSES:
        a = fg(loop[k])
        b = fe(loop[k])
        torch.cuda.synchronize()
        assert torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)
        for f in ("visible_count", "total_instances", "overflow",
                  "slot_total"):
            assert int(getattr(a.header, f)) == int(getattr(b.header, f)), f
        assert int(a.header.overflow) == 0
    assert P.counters()["graph_replays"] - c0["graph_replays"] == len(POSES)
