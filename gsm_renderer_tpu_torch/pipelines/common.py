"""Shared pipeline machinery: record-word packing, the binning chain up to
the instance sort (mono, mono with the row decomposition, stereo, foveated
stereo), the sort itself, sorted tile ids, and the 16-bit-depth-key chain
of the Global, Local and DepthFirst BITS16 frames (:func:`d16_packed_sorted`).

Port of the packed branch of ``gsm_renderer_tpu/pipelines/common.py``.
The JAX package sorts the (key1, key2) pair with ``jax.lax.sort``; here one
sort of an int64 key ``((key1 ^ 0x80000000) << 32) | key2'`` does it:
flipping bit 31 of key1 keeps the unsigned order under the signed sort
(otherwise the sentinel and the upper tile ids would sort first), and key2'
is key2 with depth_lo lifted over the zero gap above it (the plan's
``lift``), the index staying in the low ``idx_bits``.  The sort covers
only the bits from the plan's ``sort_begin_bit`` (32 - d_lo) up: tile and
depth.  Within one tile the expand writes live slots in strictly rising
entry index (an entry -- a gaussian or a virtual row -- owns at most one
slot a tile, and slot s maps to its entry through prefix offsets, so the
entry never falls as s rises), and the radix sort is stable, so each slot
takes the rank the whole-key sort gives it, ties in index order, as the
JAX package's sort of the pair.  On the CPU the plain sort is
``torch.sort`` of the whole key: live keys are unique, so it gives the
same array.  Dead slots lie outside every tile span.  The sort moves keys
only: the blend reads each instance's record words through the entry
index in the key's low bits, so no word table is gathered into sorted
order (the JAX package's gather is a TPU habit), and no index rides along
either.  The pack, the keys-only sort and the tile ranges are
``kernels/sort.py``'s (``csrc/sort.cu`` on the card).

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
key orders ties by slot, which is the gaussian order (it needs the
permutation, so it stays a pairs sort); the blend reads the entries in
sorted order (:func:`sort_and_ranges`).  Both orders are
(tile, depth, gaussian index), so the fallback renders the KeyPlan frame.

The header's sums.  No frame sums over its gaussians in torch: prep writes
the visible count, the visible rect total and the row demand beside its
offsets (``kernels/expand.py``'s header sums), and the ranges' counts pass
writes the sum of the (clamped) tile counts beside them
(``kernels/sort.py``); the frame's header reads the fields it reports
from those records (:func:`frame_output`).

The functions here open the frame's shared stage spans
(``profiling.span``): project, binning (prep, row_expand, expand), sort,
ranges, and the tail's blend and header (:func:`frame_output`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import mathlib as M
from ..kernels import sort as KS
from ..kernels.blend import blend_image
from ..kernels.expand import binning_prep, expand_slots, row_expand
from ..kernels.project import project_and_cull_packed
# public here too: the yardsticks of the sort and of the ranges
from ..kernels.sort import binning_sorted_tile, sort_key64  # noqa: F401
from ..ops import binning as B
from ..profiling import count, note_header, span
from ..types import FrameHeader, RenderOutput, RenderRecord


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
    word, the entry index), for :func:`sort_and_ranges`.  The keys come as
    a list, which :func:`sort_and_ranges` takes over and empties.  Last
    comes prep's header sums record (3,) int32 (``kernels/expand.py``'s
    ``HEADER_SUMS``)."""
    if row_capacity > 0 and (mode != "mono" or key_plan is None):
        raise ValueError("the row decomposition is a mono binning mode with "
                         "a KeyPlan")
    kw = dict(tile_w=tile_w, tile_h=tile_h, alpha_threshold=alpha_threshold)
    with span("binning"):
        with span("prep"):
            offsets, rect, mask, sums = binning_prep(
                packed.rect_word, packed.rect_h, packed.words, mode=mode,
                count_rows=row_capacity > 0, warped_bounds=warped_bounds,
                lod_min=lod_min, **kw)
        dsw, words, row_overflow = packed.dsw, packed.words, None
        if row_capacity > 0:
            with span("row_expand"):
                offsets, rect, mask, dsw, words, row_overflow = row_expand(
                    offsets, rect, mask, dsw, words,
                    row_capacity=row_capacity, **kw)
        with span("expand"):
            *keys, total, overflow = expand_slots(
                offsets, rect, mask, dsw, words, capacity=capacity,
                tiles_x=tiles_x, key_plan=key_plan, mode=mode,
                warped_bounds=warped_bounds, **kw)
        if row_overflow is not None:
            overflow = torch.maximum(overflow, row_overflow)
    return keys, words, total, overflow, sums


def sort_instances_stable(tile, depth, entry):
    """The stable fallback's instance sort (no tie-free KeyPlan fits): a
    stable sort by (tile, depth word), ties in slot order -- the gaussian
    order, a gaussian owning at most one slot a tile -- as the JAX
    package's stable 2-key ``jax.lax.sort``.  Returns (the sorted int64
    keys, the entry index of each rank as int64)."""
    sorted_key, perm = torch.sort(KS.sort_key_pack(tile, depth), stable=True)
    return sorted_key, M.u32(entry)[perm]


def tile_ranges(sorted_key, plan, num_tiles: int, max_per_tile: int = 0):
    """(starts, counts, the counts' sum) int32 of each tile's span of the
    sorted int64 keys of a KeyPlan ``plan``, or of the plain tile key when
    ``plan`` is None; the counts clamped to ``max_per_tile`` where it is
    above 0."""
    with span("ranges"):
        return KS.sort_ranges(sorted_key, num_tiles,
                              0 if plan is None else plan.d_hi, max_per_tile)


class SortedInstances(NamedTuple):
    """The sorted instance list the blend reads: rank k composites entry
    ``key[k] & (2**idx_bits - 1)``; tile t's ranks are [starts[t],
    starts[t] + counts[t]); ``total`` (0-d int32) is the sum of the
    counts."""

    key: torch.Tensor
    idx_bits: int
    starts: torch.Tensor
    counts: torch.Tensor
    total: torch.Tensor


def sort_keys(keys: list, key_plan):
    """The instance sort of the expand's ``keys``: (the sorted int64 keys,
    the key the blend reads, its index bits).  The sort takes the list of
    planes over and empties it, so that the planes' memory is free before
    the keys-only sort takes its second buffer.  With a KeyPlan the pack
    of the (key1, key2) pair with the plan's ``lift`` and the keys-only
    sort from its ``sort_begin_bit`` up (see the module docstring), whose
    sorted keys the blend reads through the plan's index field; without
    one (the stable fallback) the stable sort of (tile, depth word, entry
    index), the blend reading the sorted entries (32 index bits).  Counts
    the frame's sort path (``profiling.counters()``: ``sort_keys_only``,
    ``sort_stable``; CUB counts its radix passes, ``sort_radix_passes``)."""
    with span("sort"):
        if key_plan is None:
            count("sort_stable")
            sorted_key, entry = sort_instances_stable(*keys)
            keys.clear()
            return sorted_key, entry, 32
        count("sort_keys_only")
        packed = KS.sort_key_pack(*keys, key_plan.lift, key_plan.idx_bits)
        keys.clear()
        sorted_key = KS.sort_keys_only(packed, key_plan.sort_begin_bit)
        return sorted_key, sorted_key, key_plan.idx_bits


def sort_and_ranges(keys: list, key_plan, num_tiles: int,
                    max_per_tile: int = 0) -> SortedInstances:
    """The instance sort (:func:`sort_keys`, which empties the list
    ``keys``) and the tile ranges of the expand's planes, each tile's count
    clamped to ``max_per_tile`` where it is above 0 (the nearest
    instances)."""
    sorted_key, blend_key, idx_bits = sort_keys(keys, key_plan)
    return SortedInstances(blend_key, idx_bits,
                           *tile_ranges(sorted_key, key_plan, num_tiles,
                                        max_per_tile))


def mono_packed_sorted(gi, view, proj, center, prepared=None, *, key_plan,
                       width: int, height: int, capacity: int, tiles_x: int,
                       tiles_y: int, tile_w: int, tile_h: int, sh_degree: int,
                       alpha_threshold: float, total_ink_threshold: float,
                       near_plane: float, far_plane: float,
                       input_is_srgb: bool, mode: str = "mono",
                       row_capacity: int = 0, max_per_tile: int = 0):
    """The 32-bit-depth-key mono chain up to the tile ranges (the JAX
    ``depth_first_frame``'s packed path): the projection (the depth word
    normalized under ``key_plan``), prep in binning ``mode`` "mono" or
    "none", the row expansion when ``row_capacity`` > 0 (the plan's index
    bits then address its rows), the expand, the sort and the ranges (the
    counts clamped to ``max_per_tile`` where it is above 0).  With
    ``key_plan`` None -- no tie-free KeyPlan fits -- the raw depth key, the
    plain tile key and the stable sort, as in JAX.  Returns
    (:class:`SortedInstances`, the projection, the entry words, the
    unclamped slot total, the overflow flag, prep's header sums)."""
    with span("project"):
        packed = project_and_cull_packed(
            gi, view, proj, center, prepared=prepared, width=width,
            height=height, tile_w=tile_w, tile_h=tile_h, sh_degree=sh_degree,
            near_plane=near_plane, far_plane=far_plane,
            alpha_threshold=alpha_threshold,
            total_ink_threshold=total_ink_threshold,
            input_is_srgb=input_is_srgb, key_plan=key_plan)
    keys, entry_words, slot_total, overflow, sums = binning_sort_operands(
        packed, capacity=capacity, tiles_x=tiles_x, key_plan=key_plan,
        mode=mode, row_capacity=row_capacity, tile_w=tile_w, tile_h=tile_h,
        alpha_threshold=alpha_threshold)
    return (sort_and_ranges(keys, key_plan, tiles_x * tiles_y, max_per_tile),
            packed, entry_words, slot_total, overflow, sums)


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
                      input_is_srgb: bool, mode: str = "mono",
                      max_per_tile: int = 0):
    """The 16-bit-depth-key chain up to the tile ranges, shared by the
    Global, Local, DepthFirst BITS16 and Hardware BITS16 frames (the JAX
    ``d16_packed_sorted``): the projection emitting the half-depth key, prep
    and expand in binning ``mode`` "mono" (exact-tested) or "none" (full
    rects), and the unstable keys-only sort under the d16 KeyPlan
    ``key_plan`` (:func:`d16_key_plan`, see the module docstring), or, with
    ``key_plan`` None, the plain tile key and the stable sort by (tile,
    depth16); the tile counts clamped to ``max_per_tile`` where it is
    above 0.  Returns (:class:`SortedInstances`, the projection, the
    unclamped slot total, the overflow flag, prep's header sums)."""
    with span("project"):
        packed = project_and_cull_packed(
            gi, view, proj, center, prepared=prepared, width=width,
            height=height, tile_w=tile_w, tile_h=tile_h, sh_degree=sh_degree,
            near_plane=near_plane, far_plane=far_plane,
            alpha_threshold=alpha_threshold,
            total_ink_threshold=total_ink_threshold,
            input_is_srgb=input_is_srgb, depth_key16=True)
    keys, _words, slot_total, overflow, sums = binning_sort_operands(
        packed, capacity=capacity, tiles_x=tiles_x, key_plan=key_plan,
        mode=mode, tile_w=tile_w, tile_h=tile_h,
        alpha_threshold=alpha_threshold)
    return (sort_and_ranges(keys, key_plan, tiles_x * tiles_y, max_per_tile),
            packed, slot_total, overflow, sums)


def used_sh_degree(config, gi) -> int:
    """The SH degree a frame evaluates: the config's, capped by the
    input's coefficients."""
    return min(config.sh_degree, {1: 0, 4: 1, 9: 2, 16: 3}[gi.sh_n_coeffs])


def frame_output(srt: SortedInstances, entry_words, sums, *, slot_total,
                 overflow, capacity: int, rect_total: bool = False,
                 rows: bool = False, **blend_kw) -> RenderOutput:
    """The tail of every frame function: in ``gsm::blend`` the blend of the
    sorted instances ``srt`` over the ``entry_words`` (``blend_kw``: the
    tile grid, the size and the blend's options); in ``gsm::header`` the
    header, read from the records the kernels wrote, no sum taken: the
    visible count from prep's header sums ``sums``, ``total_instances`` the
    sum of the blended tile counts (``srt.total``) or, with
    ``rect_total``, prep's visible rect total, ``row_total`` prep's row
    demand with ``rows``, beside the expand's ``slot_total`` and
    ``overflow``; the header noted for the frame's record at its
    ``capacity`` (:func:`profiling.note_header`).  Counts
    ``header_sums_kernel`` where the records are the card's,
    ``header_sums_torch`` where the plain versions summed them in torch
    (CPU tensors)."""
    with span("blend"):
        color, depth = blend_image(srt.key, entry_words, srt.idx_bits,
                                   srt.starts, srt.counts, **blend_kw)
    with span("header"):
        count("header_sums_kernel" if sums.is_cuda else "header_sums_torch")
        visible, rect_sum, row_sum = sums.unbind()
        header = FrameHeader(
            visible_count=visible,
            total_instances=rect_sum if rect_total else srt.total,
            overflow=overflow, slot_total=slot_total,
            row_total=row_sum if rows else None)
    note_header(header, capacity)
    return RenderOutput(color=color, depth=depth, header=header)
