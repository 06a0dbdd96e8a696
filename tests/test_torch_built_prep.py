"""Prep parity on built inputs, modes mono (``count_rows``, as the rows-on
frame runs it, and full rects, as the rows-off frame does) and stereo: the
port's plain ``binning_prep`` against the JAX package's
``binning_prep_pallas`` (interpret mode) at 1, 31, 255, 256, 257 and 4097
gaussians, sizes that put the CUDA prep and row-expand kernels' warps,
blocks and look-back tiles at their edges.  The built inputs and the check
are shared with tests/test_torch_built_prep_warped.py and
tests/test_torch_built_rows.py.

``built_gaussians``: made with numpy from a seed; the first warp is skewed
(one lane holds an 8x4 window of 32 tests, the rest 1x1 rects), then a
block-sized run of culled gaussians, one of oversized rects (32 tests each,
counted as rows or full rects), and mixed rects (0-12 x 0-6 tiles, 10%
culled) for the rest.

Tolerance of ``check_prep``, as in tests/test_torch_binning.py: the 8x4
masks may differ by float-boundary flips (cos/sin/log differ by an ulp
between XLA and PyTorch), at most 0.2% of the gaussians; every other
gaussian's count and rect word are equal, and the offsets are equal where
no mask flipped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsm_renderer_tpu.kernels import expand as JE
from gsm_renderer_tpu.stereo import foveated_raster_tables, make_rate_maps

from gsm_renderer_tpu_torch.kernels import expand as TE

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

SIZES = (1, 31, 255, 256, 257, 4097)
MODES = {
    "mono_rows": dict(count_rows=True),
    "mono_full": dict(),
    "stereo": dict(mode="stereo"),
    "warped_lod0": dict(mode="warped", lod_min=0.0),
    "warped_lod5": dict(mode="warped", lod_min=5.0),
}


def built_gaussians(n: int, seed: int = 3):
    """(rect_word uint32, rect_h int32, 8 word rows uint32) of ``n`` built
    gaussians on a 120 x 68 tile grid (see the module docstring); the right
    eye's record sits 25 px left of the left one's, and the eyes share w3."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    min_tx = rng.integers(0, 112, n)
    min_ty = rng.integers(0, 64, n)
    rect_w = rng.integers(0, 13, n)
    rect_h = rng.integers(0, 7, n)
    culled = rng.random(n) < 0.1
    skewed = idx < 32
    heavy = skewed & (idx == 7)
    rect_w = np.where(skewed, np.where(heavy, 8, 1), rect_w)
    rect_h = np.where(skewed, np.where(heavy, 4, 1), rect_h)
    culled = np.where(skewed, False, culled)
    culled = np.where((idx >= 32) & (idx < 288), True, culled)
    oversized = (idx >= 288) & (idx < 544)
    rect_w = np.where(oversized, rng.integers(9, 31, n), rect_w)
    rect_h = np.where(oversized, rng.integers(5, 13, n), rect_h)
    culled = np.where(oversized, False, culled)
    rect_word = (min_tx | (min_ty << 10) | (rect_w << 20)
                 | np.where(culled, TE.CULLED_BIT, 0)).astype(np.uint32)
    span_x = np.minimum(rect_w, 8) + 2.0
    span_y = np.minimum(rect_h, 4) + 2.0
    mx = (min_tx - 1.0 + span_x * rng.random(n)) * 16.0
    my = (min_ty - 1.0 + span_y * rng.random(n)) * 16.0

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
    return rect_word, rect_h.astype(np.int32), rows


def i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def warped_bounds():
    """The (2, 128) bounds table of the 1080p foveated target."""
    return foveated_raster_tables(make_rate_maps(1920, 1080, min_rate=0.4,
                                                 radius=0.3))["bounds"]


def jax_prep(n, kw, bounds, words, rect_word, rect_h):
    kw = dict(kw)
    if kw.get("mode") == "warped":
        kw["warped_bounds"] = jnp.asarray(bounds)
    tab = JE.binning_prep_pallas(jnp.asarray(rect_word), jnp.asarray(rect_h),
                                 jnp.zeros(n, jnp.uint32),
                                 [jnp.asarray(w) for w in words],
                                 interpret=True, **kw)
    flat = np.asarray(tab).reshape(tab.shape[0], -1)
    return flat[0, :n + 1], flat[1, :n], flat[2, :n]


def mode_words(kw, rows):
    """The record words a prep mode carries."""
    return rows[:4] if kw.get("mode") is None else rows


def port_prep(kw, bounds, words, rect_word, rect_h):
    """The port's plain prep on the same inputs, as torch tensors."""
    kw = dict(kw)
    if kw.get("mode") == "warped":
        kw["warped_bounds"] = torch.from_numpy(np.asarray(bounds, np.float32))
    return TE.binning_prep_plain(i32(rect_word), i32(rect_h),
                                 [i32(w) for w in words], **kw)


def check_prep(n, mode):
    """The port's plain prep against the JAX prep on ``n`` built gaussians
    in ``mode`` (a key of MODES), within the module docstring's tolerance."""
    rect_word, rect_h, rows = built_gaussians(n)
    kw, bounds = MODES[mode], warped_bounds()
    words = mode_words(kw, rows)
    off_ref, rect_ref, mask_ref = jax_prep(n, kw, bounds, words, rect_word,
                                           rect_h)
    offsets, rect, mask = port_prep(kw, bounds, words, rect_word, rect_h)
    flips = u32(mask.numpy()) != u32(mask_ref)
    assert flips.sum() <= int(0.002 * n), f"{flips.sum()} mask flips"
    same = ~flips
    cnt_ref = np.diff(off_ref.astype(np.int64))
    cnt_got = np.diff(offsets.numpy().astype(np.int64))
    np.testing.assert_array_equal(cnt_got[same], cnt_ref[same])
    np.testing.assert_array_equal(u32(rect.numpy())[same], u32(rect_ref)[same])
    if not flips.any():
        np.testing.assert_array_equal(offsets.numpy(), off_ref)
    assert (cnt_got >= 1).all()


@pytest.mark.parametrize("mode", ["mono_rows", "mono_full", "stereo"])
@pytest.mark.parametrize("n", SIZES)
def test_prep_matches_pallas_on_built_inputs(n, mode):
    check_prep(n, mode)
