"""Shared pipeline machinery: record-word packing, the binning chain up to
the instance sort (mono, mono with the row decomposition, stereo, foveated
stereo), the sort itself, and sorted tile ids.

Port of the packed branch of ``gsm_renderer_tpu/pipelines/common.py``.
The JAX package sorts the (key1, key2) pair with ``jax.lax.sort``; here one
``torch.sort`` on an int64 key ``((key1 ^ 0x80000000) << 32) | key2`` does
it: flipping bit 31 of key1 keeps the unsigned order under the signed sort
(otherwise the sentinel and the upper tile ids would sort first).  KeyPlan
keys are unique for live slots, so the unstable sort is exact; dead slots
lie outside every tile span, so their order does not matter.  The sort moves
keys only: the blend reads each instance's record words through the entry
index in the key's low bits, so no word table is gathered into sorted order
(the JAX package's gather is a TPU habit).
"""

from __future__ import annotations

import torch

from .. import mathlib as M
from ..kernels.expand import SENTINEL, binning_prep, expand_slots, row_expand
from ..types import RenderRecord


def pack_record_words(record: RenderRecord):
    """Pack the quantized record into (N, 4) int32 words:

      word0 = mean_x.f16 | mean_y.f16 << 16
      word1 = theta.u16  | sigma1.f16 << 16
      word2 = sigma2.f16 | depth.f16 << 16
      word3 = r | g << 8 | b << 16 | opacity << 24
    """
    def f16b(x):
        return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF

    def u(x):
        return x.to(torch.int64)

    w0 = f16b(record.mean_x) | (f16b(record.mean_y) << 16)
    w1 = u(record.theta) | (f16b(record.sigma1) << 16)
    w2 = f16b(record.sigma2) | (f16b(record.depth) << 16)
    w3 = (u(record.color[:, 0]) | (u(record.color[:, 1]) << 8)
          | (u(record.color[:, 2]) << 16) | (u(record.opacity) << 24))
    return torch.stack([M.to_i32(w) for w in (w0, w1, w2, w3)], dim=-1)


def unpack_record_words(words):
    """Inverse of :func:`pack_record_words`; returns a dict of float32
    fields."""
    def half(w):
        return M.to_i32(w & 0xFFFF).to(torch.int16).view(torch.float16).to(
            torch.float32)

    w0, w1, w2, w3 = (M.u32(words[..., i]) for i in range(4))
    inv255 = 1.0 / 255.0
    return {
        "mean_x": half(w0), "mean_y": half(w0 >> 16),
        "theta": (w1 & 0xFFFF).to(torch.float32) * (M.PI / 65535.0),
        "sigma1": half(w1 >> 16), "sigma2": half(w2), "depth": half(w2 >> 16),
        "r": (w3 & 0xFF).to(torch.float32) * inv255,
        "g": ((w3 >> 8) & 0xFF).to(torch.float32) * inv255,
        "b": ((w3 >> 16) & 0xFF).to(torch.float32) * inv255,
        "op": ((w3 >> 24) & 0xFF).to(torch.float32) * inv255,
    }


def binning_sort_operands(packed, *, capacity: int, tiles_x: int, key_plan,
                          mode: str = "mono", row_capacity: int = 0,
                          tile_w: int = 16, tile_h: int = 16,
                          alpha_threshold: float = 0.005, warped_bounds=None,
                          lod_min: float = 0.0):
    """Prep + (row expansion) + expand of a packed projection.

    ``mode`` "mono" carries the 4 record words, "stereo" the 8 of a
    :class:`StereoPackedProjection`, "warped" the same 8 over the foveated
    physical tile grid, whose display-space tile rects come from the (2,
    128) ``warped_bounds`` table (with the periphery LOD drop at prep when
    ``lod_min`` > 0).  ``row_capacity`` > 0 (mono only)
    counts virtual rows at prep, narrows oversized rects to their exact
    per-row spans and expands over the R = ``row_capacity`` rows; the
    KeyPlan's index bits must then address R rows.  Returns ((key1 (C,),
    key2 (C,)) int32, the entry words the blend reads through key2's index
    field (K rows of (N,) int32: the projection's words, or the row table's
    (R,) rows), the unclamped slot total and the overflow flag (0-d int32;
    with rows, also set when the row demand exceeds R))."""
    if row_capacity > 0 and mode != "mono":
        raise ValueError("the row decomposition is a mono binning mode")
    kw = dict(tile_w=tile_w, tile_h=tile_h, alpha_threshold=alpha_threshold)
    offsets, rect, mask = binning_prep(packed.rect_word, packed.rect_h,
                                       packed.words, mode=mode,
                                       count_rows=row_capacity > 0,
                                       warped_bounds=warped_bounds,
                                       lod_min=lod_min, **kw)
    dsw, words, row_overflow = packed.dsw, packed.words, None
    if row_capacity > 0:
        offsets, rect, mask, dsw, words, row_overflow = row_expand(
            offsets, rect, mask, dsw, words, row_capacity=row_capacity, **kw)
    key1, key2, total, overflow = expand_slots(
        offsets, rect, mask, dsw, words, capacity=capacity, tiles_x=tiles_x,
        key_plan=key_plan, mode=mode, warped_bounds=warped_bounds, **kw)
    if row_overflow is not None:
        overflow = torch.maximum(overflow, row_overflow)
    return (key1, key2), words, total, overflow


def sort_key64(key1, key2):
    """The int64 key whose signed order is the unsigned (key1, key2) order."""
    return ((M.u32(key1) ^ 0x80000000) << 32) | M.u32(key2)


def sort_instances(key1, key2):
    """Unstable instance sort by (key1, key2): the sorted int64 keys."""
    return torch.sort(sort_key64(key1, key2), stable=False).values


def binning_sorted_tile(sorted_key, *, plan_tuple):
    """Sorted tile ids (int64; SENTINEL for dead slots) from the sorted
    int64 keys."""
    k1 = ((sorted_key >> 32) & M.U32) ^ 0x80000000
    return torch.where(k1 == SENTINEL, SENTINEL, k1 >> plan_tuple[0])
