"""Shared pipeline machinery: record-word packing, the binning chain up to
the instance sort (mono, mono with the row decomposition, stereo, foveated
stereo), the sort itself, sorted tile ids, and the 16-bit-depth-key chain
of the Global, Local and DepthFirst BITS16 frames (:func:`d16_packed_sorted`).

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

One key order for the 16-bit depth keys.  The JAX Global and Local frames,
and its DepthFirst frame with 16-bit depth keys and tile ids, sort one fused
key [tile:16 | depth16:16] with a stable sort over slots emitted in
gaussian order; its DepthFirst frame with 16-bit depth keys and 32-bit tile
ids uses the KeyPlan ``make_key_plan(num_tiles, n, depth_span_bits=16)``.
That plan has d_hi = 32 - tile_bits >= 16 and d_lo = 0, so key1 = tile <<
d_hi | depth16 and key2 = the gaussian index: the pair orders slots by
(tile, depth16, gaussian index).  A gaussian has at most one slot per tile
and the expand emits slots in gaussian order, so that is exactly the stable
fused-key order.  All four configurations therefore go through the same
KeyPlan expand, unstable keys-only sort and blend through the entry index;
the fused key needs no layout of its own.

The stable fallback.  Where no tie-free KeyPlan fits (``make_key_plan``
returns None: more tile, depth-span and index bits than 64 hold, as for 4M
gaussians on a 3840x2160 grid at 32-bit depth keys), the JAX package keys
each slot by the plain tile id with the depth word beside it and sorts the
pair stably.  Here the expand writes the tile, the depth word and the
slot's entry index; one stable ``torch.sort`` of the (tile, depth) int64
key orders ties by slot, which is the gaussian order; the blend reads the
entries in sorted order (:func:`sort_and_ranges`).  Both orders are
(tile, depth, gaussian index), so the fallback renders the KeyPlan frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config as cfg
from .. import mathlib as M
from ..kernels.expand import SENTINEL, binning_prep, expand_slots, row_expand
from ..kernels.project import cached_projection_inputs, project_and_cull_packed
from ..ops import binning as B
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

    ``mode`` "mono" carries the 4 record words (exact-tested), "none" the
    same 4 over full rects (the Hardware frame), "stereo" the 8 of a
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
    with rows, also set when the row demand exceeds R)).  With ``key_plan``
    None (the stable fallback; no rows) the keys are (the tile, the depth
    word, the entry index), for :func:`sort_and_ranges`."""
    if row_capacity > 0 and (mode != "mono" or key_plan is None):
        raise ValueError("the row decomposition is a mono binning mode with "
                         "a KeyPlan")
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
    *keys, total, overflow = expand_slots(
        offsets, rect, mask, dsw, words, capacity=capacity, tiles_x=tiles_x,
        key_plan=key_plan, mode=mode, warped_bounds=warped_bounds, **kw)
    if row_overflow is not None:
        overflow = torch.maximum(overflow, row_overflow)
    return tuple(keys), words, total, overflow


def sort_key64(key1, key2):
    """The int64 key whose signed order is the unsigned (key1, key2) order."""
    return ((M.u32(key1) ^ 0x80000000) << 32) | M.u32(key2)


def sort_instances(key1, key2):
    """Unstable instance sort by (key1, key2): the sorted int64 keys."""
    return torch.sort(sort_key64(key1, key2), stable=False).values


def sort_instances_stable(tile, depth, entry):
    """The stable fallback's instance sort (no tie-free KeyPlan fits): a
    stable sort by (tile, depth word), ties in slot order -- the gaussian
    order, a gaussian owning at most one slot a tile -- as the JAX
    package's stable 2-key ``jax.lax.sort``.  Returns (the sorted int64
    keys, the entry index of each rank as int64)."""
    sorted_key, perm = torch.sort(sort_key64(tile, depth), stable=True)
    return sorted_key, M.u32(entry)[perm]


def binning_sorted_tile(sorted_key, *, plan_tuple):
    """Sorted tile ids (int64; SENTINEL for dead slots) from the sorted
    int64 keys; ``plan_tuple`` None for the stable fallback's plain tile
    key."""
    k1 = ((sorted_key >> 32) & M.U32) ^ 0x80000000
    shift = 0 if plan_tuple is None else plan_tuple[0]
    return torch.where(k1 == SENTINEL, SENTINEL, k1 >> shift)


def tile_ranges(sorted_key, plan, num_tiles: int):
    """(starts, counts) int32 of each tile's span of the sorted int64 keys
    of a KeyPlan ``plan``, or of the plain tile key when ``plan`` is
    None."""
    sorted_tile = binning_sorted_tile(
        sorted_key, plan_tuple=None if plan is None else plan.kernel_tuple)
    return B.extract_tile_ranges(sorted_tile, num_tiles)


class SortedInstances(NamedTuple):
    """The sorted instance list the blend reads: rank k composites entry
    ``key[k] & (2**idx_bits - 1)``; tile t's ranks are [starts[t],
    starts[t] + counts[t])."""

    key: torch.Tensor
    idx_bits: int
    starts: torch.Tensor
    counts: torch.Tensor


def sort_keys(keys, key_plan):
    """The instance sort of the expand's ``keys``: (the sorted int64 keys,
    the key the blend reads, its index bits).  With a KeyPlan the unstable
    sort of the (key1, key2) pair, whose sorted keys the blend reads
    through the plan's index field; without one (the stable fallback) the
    stable sort of (tile, depth word, entry index), the blend reading the
    sorted entries (32 index bits)."""
    if key_plan is None:
        sorted_key, entry = sort_instances_stable(*keys)
        return sorted_key, entry, 32
    sorted_key = sort_instances(*keys)
    return sorted_key, sorted_key, key_plan.idx_bits


def sort_and_ranges(keys, key_plan, num_tiles: int) -> SortedInstances:
    """The instance sort (:func:`sort_keys`) and the tile ranges of the
    expand's ``keys``."""
    sorted_key, blend_key, idx_bits = sort_keys(keys, key_plan)
    return SortedInstances(blend_key, idx_bits,
                           *tile_ranges(sorted_key, key_plan, num_tiles))


def mono_packed_sorted(gi, view, proj, center, prepared=None, *, key_plan,
                       width: int, height: int, capacity: int, tiles_x: int,
                       tiles_y: int, tile_w: int, tile_h: int, sh_degree: int,
                       alpha_threshold: float, total_ink_threshold: float,
                       near_plane: float, far_plane: float,
                       input_is_srgb: bool, mode: str = "mono",
                       row_capacity: int = 0):
    """The 32-bit-depth-key mono chain up to the tile ranges (the JAX
    ``depth_first_frame``'s packed path): the projection (the depth word
    normalized under ``key_plan``), prep in binning ``mode`` "mono" or
    "none", the row expansion when ``row_capacity`` > 0 (the plan's index
    bits then address its rows), the expand, the sort and the ranges.  With
    ``key_plan`` None -- no tie-free KeyPlan fits -- the raw depth key, the
    plain tile key and the stable sort, as in JAX.  Returns
    (:class:`SortedInstances`, the projection, the entry words, the
    unclamped slot total, the overflow flag)."""
    packed = project_and_cull_packed(
        gi, view, proj, center, prepared=prepared, width=width, height=height,
        tile_w=tile_w, tile_h=tile_h, sh_degree=sh_degree,
        near_plane=near_plane, far_plane=far_plane,
        alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb,
        key_plan=key_plan)
    keys, entry_words, slot_total, overflow = binning_sort_operands(
        packed, capacity=capacity, tiles_x=tiles_x, key_plan=key_plan,
        mode=mode, row_capacity=row_capacity, tile_w=tile_w, tile_h=tile_h,
        alpha_threshold=alpha_threshold)
    return (sort_and_ranges(keys, key_plan, tiles_x * tiles_y), packed,
            entry_words, slot_total, overflow)


def d16_key_plan(num_tiles: int, n: int):
    """The d16 KeyPlan of a 16-bit-depth-key frame (see the module
    docstring), or None when its index field does not fit (more than 16
    tile bits and too many gaussians)."""
    return B.make_key_plan(num_tiles, n, depth_span_bits=16)


def d16_packed_sorted(gi, view, proj, center, prepared=None, *, key_plan,
                      width: int, height: int, capacity: int, tiles_x: int,
                      tiles_y: int, tile_w: int, tile_h: int, sh_degree: int,
                      alpha_threshold: float, total_ink_threshold: float,
                      near_plane: float, far_plane: float,
                      input_is_srgb: bool, mode: str = "mono"):
    """The 16-bit-depth-key chain up to the tile ranges, shared by the
    Global, Local, DepthFirst BITS16 and Hardware BITS16 frames (the JAX
    ``d16_packed_sorted``): the projection emitting the half-depth key, prep
    and expand in binning ``mode`` "mono" (exact-tested) or "none" (full
    rects), and the unstable keys-only sort under the d16 KeyPlan
    ``key_plan`` (:func:`d16_key_plan`, see the module docstring), or, with
    ``key_plan`` None, the plain tile key and the stable sort by (tile,
    depth16).  Returns (:class:`SortedInstances`, the projection, the
    unclamped slot total, the overflow flag)."""
    packed = project_and_cull_packed(
        gi, view, proj, center, prepared=prepared, width=width, height=height,
        tile_w=tile_w, tile_h=tile_h, sh_degree=sh_degree,
        near_plane=near_plane, far_plane=far_plane,
        alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb,
        depth_key16=True)
    keys, _words, slot_total, overflow = binning_sort_operands(
        packed, capacity=capacity, tiles_x=tiles_x, key_plan=key_plan,
        mode=mode, tile_w=tile_w, tile_h=tile_h,
        alpha_threshold=alpha_threshold)
    return (sort_and_ranges(keys, key_plan, tiles_x * tiles_y), packed,
            slot_total, overflow)


def used_sh_degree(config, gi) -> int:
    """The SH degree a frame evaluates: the config's, capped by the
    input's coefficients."""
    return min(config.sh_degree, {1: 0, 4: 1, 9: 2, 16: 3}[gi.sh_n_coeffs])


def d16_frame_kwargs(renderer, gi, camera, width: int, height: int) -> dict:
    """The keyword arguments a Global or Local frame takes from the
    renderer's config, the input and the camera (the capacity of the
    renderer's own kind, the cached projection layout)."""
    c = renderer.config
    sh_degree = used_sh_degree(c, gi)
    return dict(
        width=width, height=height,
        capacity=renderer.pick_capacity(gi.count, kind=renderer._mono_key),
        sh_degree=sh_degree, alpha_threshold=c.alpha_threshold,
        total_ink_threshold=c.total_ink_threshold,
        near_plane=camera.near_plane, far_plane=camera.far_plane,
        input_is_srgb=c.gaussian_color_space == cfg.GaussianColorSpace.SRGB,
        prepared=cached_projection_inputs(gi, sh_degree))
