"""Row-expansion parity on built inputs: the port's plain ``row_expand``
against the JAX package's ``row_expand_pallas`` (interpret mode) on the JAX
``count_rows`` prep table of 1, 31, 255, 256, 257 and 4097 built gaussians
(tests/test_torch_built_prep.py), with the row capacity below the row total (rows
past it dropped, row_overflow set), equal to it and above it (a dead tail
of zero rows).  Below is 100 rows short, or 1 row where the total is at
most 100.

Tolerance, as in tests/test_torch_rows.py: the mask, depth and record
planes equal exactly; a row's rect word and count may flip only at a span
boundary (the span's lo or hi end moves by one tile, same tile row), at
most 0.2% of the rows; the offsets are equal where nothing flipped.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_built_prep import SIZES, built_gaussians, i32, u32
from gsm_renderer_tpu.kernels import expand as JE

from gsm_renderer_tpu_torch.kernels import expand as TE

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_row_table(n: int):
    """The JAX count_rows prep table of ``n`` built gaussians (mono words,
    random depth words) and its planes as numpy."""
    rect_word, rect_h, rows = built_gaussians(n)
    dsw = np.random.default_rng(n).integers(0, 1 << 31, n).astype(np.uint32)
    tab = JE.binning_prep_pallas(jnp.asarray(rect_word), jnp.asarray(rect_h),
                                 jnp.asarray(dsw),
                                 [jnp.asarray(w) for w in rows[:4]],
                                 interpret=True, count_rows=True)
    return tab, np.asarray(tab).reshape(tab.shape[0], -1)


@pytest.mark.parametrize("cap", ["below", "equal", "above"])
@pytest.mark.parametrize("n", SIZES)
def test_row_expand_matches_pallas_on_built_inputs(n, cap):
    tab, flat = jax_row_table(n)
    total = int(flat[0, n])
    r_cap = {"below": max(total - 100, 1), "equal": total,
             "above": total + 300}[cap]
    ref, ref_ov = JE.row_expand_pallas(tab, n=n, row_capacity=r_cap,
                                       interpret=True)
    ref = np.asarray(ref).reshape(ref.shape[0], -1)
    off2, rect2, mask2, dsw2, words2, ov = TE.row_expand_plain(
        i32(flat[0, :n + 1]), i32(flat[1, :n]), i32(flat[2, :n]),
        i32(flat[3, :n]), [i32(flat[4 + k, :n]) for k in range(4)],
        row_capacity=r_cap)
    assert int(ov) == int(ref_ov) == int(total > r_cap)
    for k, got in enumerate([mask2, dsw2] + words2):
        np.testing.assert_array_equal(u32(got.numpy()), u32(ref[2 + k, :r_cap]),
                                      err_msg=f"plane {2 + k}")
    r_ref, r_got = u32(ref[1, :r_cap]), u32(rect2.numpy())
    flips = np.nonzero(r_ref != r_got)[0]
    assert len(flips) <= int(0.002 * r_cap), f"{len(flips)} rect flips"
    for r in flips:  # only at a span boundary
        lo_a, ty_a, w_a = r_ref[r] & 0x3FF, (r_ref[r] >> 10) & 0x3FF, (r_ref[r] >> 20) & 0x3FF
        lo_b, ty_b, w_b = r_got[r] & 0x3FF, (r_got[r] >> 10) & 0x3FF, (r_got[r] >> 20) & 0x3FF
        assert ty_a == ty_b and abs(int(lo_a) - int(lo_b)) <= 1
        assert abs(int(lo_a + w_a) - int(lo_b + w_b)) <= 1
    counts_ref = np.diff(ref[0, :r_cap + 1].astype(np.int64))
    counts_got = np.diff(off2.numpy().astype(np.int64))
    same = r_ref == r_got
    np.testing.assert_array_equal(counts_got[same], counts_ref[same])
    if not len(flips):
        np.testing.assert_array_equal(off2.numpy(), ref[0, :r_cap + 1])
    if cap == "above":
        assert (counts_got[total:] == 0).all() and (r_got[total:] == 0).all()
