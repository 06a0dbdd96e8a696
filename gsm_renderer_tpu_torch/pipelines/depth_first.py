"""DepthFirstRenderer: the flagship pipeline, mono, side-by-side stereo and
foveated stereo.

Port of ``gsm_renderer_tpu/pipelines/depth_first.py`` (``depth_first_frame``,
``depth_first_stereo_frame`` and ``depth_first_stereo_foveated_frame`` on
their packed paths, ``DepthFirstRenderer.render`` / ``render_stereo`` /
``render_stereo_foveated`` / ``render_stereo_foveated_compress``,
``_mono_render``, ``_stereo_render`` and ``_stereo_foveated_render``).  A
mono frame is

  1. project + cull + quantize + pack        kernels/project.py   (kernel 1)
  2. binning prep: masks, counts, scan       kernels/expand.py    (kernel 2)
  3. row expansion (``row_expand``)          kernels/expand.py    (kernel 3)
  4. slot expansion into KeyPlan keys        kernels/expand.py    (kernel 4)
  5. unstable sort of the int64 keys alone   pipelines/common.py  (torch.sort;
     a stable sort of (tile, depth) where no tie-free KeyPlan fits)
  6. tile ranges                             ops/binning.py       (searchsorted)
  7. blend + assemble, records read through
     the keys' entry index                   kernels/blend.py     (kernel 5)

With 16-bit depth keys (``depth_sort_key_precision=BITS16``) the mono frame
takes the Global and Local renderers' chain instead
(:func:`~gsm_renderer_tpu_torch.pipelines.common.d16_packed_sorted`: the
projection emits the half-depth key, no row decomposition, the d16 KeyPlan
for both tile-id precisions).

A stereo frame projects both eyes in one pass (kernel 6), bins the union
rects with the dual-eye q <= 9 test carrying 8 record words, and blends both
eyes in one pass into an (H, 2W) image.  A foveated stereo frame
rasterizes directly into the reduced-rate physical target of a
:class:`~gsm_renderer_tpu_torch.stereo.FoveatedStereoTarget`: the dual-eye
projection runs at the display size, each gaussian's display pixel bounds
are re-binned onto the physical tile grid through the fitted inverse warp
(plain torch on the device, :func:`foveated_rects`), prep and expand run in
mode "warped" (display-space tile rects from the bounds table), and the
blend samples each physical pixel at its display-space coordinate.  No host
read except the capacity lock-in (pipelines/base.py).

The Hardware renderer (pipelines/hardware.py) is this class with other
settings: its mono frame expands full rects (``exact_tile_test=False``:
prep and the expand in mode "none") and blends with the r^2 <= 9 cutoff
and normalized depth; its stereo and foveated frames are these frames with
normalized depth.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config as cfg
from .. import mathlib as M
from ..kernels.blend import blend_image
from ..kernels.expand import (CULLED_BIT, MASK_H, MASK_W, STEREO_R2_CUTOFF,
                              check_tile)
from ..kernels.project import (cached_projection_inputs,
                               stereo_project_and_cull_packed)
from ..mathlib import u32
from ..ops import binning as B
from ..stereo import compress_foveated, foveated_raster_tables
from ..types import FrameHeader, RenderOutput
from .base import GaussianRenderer
from .common import (binning_sort_operands, d16_key_plan, d16_packed_sorted,
                     mono_packed_sorted, sort_and_ranges, used_sh_degree)


def _row_demand(rect_word, rect_h):
    """Virtual-row demand of the per-row decomposition (one row per
    mask-eligible or culled gaussian, ``rect_h`` per oversized rect); the
    header reports it every frame, as the JAX package does."""
    rw = u32(rect_word)
    visible = (rw & CULLED_BIT) == 0
    rect_w = (rw >> 20) & 0x3FF
    oversized = visible & ((rect_w > MASK_W) | (rect_h > MASK_H))
    return torch.where(oversized, rect_h, 1).sum().to(torch.int32)


def visible_rect_total(rect_word, rect_h, visible):
    """The rect total of the visible gaussians, sum of rect_w * rect_h
    (int32): the header's ``total_instances`` where the JAX frame reports
    its XLA binning's ``total_live`` (stereo, foveated, ``max_per_tile``)."""
    rect_w = (u32(rect_word) >> 20) & 0x3FF
    return torch.where(visible, rect_w * rect_h, 0).sum().to(torch.int32)


def _mono_key_statics(n_gaussians: int, *, width, height, tile_w, tile_h,
                      near_plane, far_plane, row_capacity: int = 0):
    """The mono frame's KeyPlan for 32-bit depth keys (the same plan for 16-
    and 32-bit tile ids).  With
    ``row_capacity`` > 0 its index bits address virtual rows; None when the
    index field no longer fits -- callers then run with
    ``row_capacity=0``, and with no plan at all the stable fallback."""
    tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
    key_n = row_capacity if row_capacity > 0 else n_gaussians
    return B.make_key_plan(tiles_x * tiles_y, key_n, near_plane=near_plane,
                           far_plane=far_plane)


def depth_first_frame(gi, view, proj, center, prepared=None, *, width: int,
                      height: int, capacity: int, sh_degree: int,
                      alpha_threshold: float, total_ink_threshold: float,
                      near_plane: float, far_plane: float,
                      input_is_srgb: bool, tile_w: int = 16, tile_h: int = 16,
                      depth_mode: str = "weighted",
                      row_capacity: int = 0, tile_id_bits: int = 16,
                      depth_key_bits: int = 32, exact_tile_test: bool = True,
                      r2_cutoff: float = 0.0, max_per_tile: int = 0,
                      back_to_front: bool = False) -> RenderOutput:
    """One mono DepthFirst frame on the device of ``gi``.  ``view``/``proj``
    (4, 4) and ``center`` (3,) are host arrays; ``prepared`` an optional
    cached (comp, harm) projection layout.  ``row_capacity`` > 0 runs the
    per-row exact-span decomposition of oversized rects over that many
    virtual rows (bitwise-identical image, smaller slot volume) when the
    row-addressing KeyPlan fits, else the full-rect expansion.
    ``depth_key_bits`` 16 sorts by the 16-bit half-depth key (the d16 chain
    of pipelines/common.py; rows off, as in JAX).  Where no tie-free
    KeyPlan fits, the frame sorts stably by the plain tile key with rows off
    (``pipelines/common.py``), as JAX does, and renders the same image.  The
    frame is the same
    for ``tile_id_bits`` 16 and 32 under either depth key: the bits only
    gate the 16-bit tile-id guard below (in JAX also the choice between the
    fused depth16 key and the d16 KeyPlan, which order the slots alike).

    ``exact_tile_test=False`` + ``depth_mode="normalized"`` + ``r2_cutoff=9``
    is the Hardware renderer's frame: every tile of a visible gaussian's
    clamped rect is an instance (prep and the expand in mode "none", rows
    off), the blend zeroes alpha past q = r2_cutoff, and the header has no
    ``row_total``, as in JAX.

    ``max_per_tile`` > 0 (the Local renderer's clamp on this frame) blends
    at most that many instances a tile, the nearest, with rows off; the
    header's ``total_instances`` is then the visible gaussians' rect total
    (sum of rect_w * rect_h), as JAX's XLA binning path reports it there,
    while ``slot_total`` is prep's, the same as without the clamp.
    ``back_to_front`` renders the same frame: the radiance weights a_i *
    prod_{nearer j}(1 - a_j) are those of front-to-back compositing (JAX
    drops it too).  Tiles: each side 1 to 4096 pixels."""
    del back_to_front
    check_tile(tile_w, tile_h)
    tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
    num_tiles = tiles_x * tiles_y
    if tile_id_bits == 16 and num_tiles > 0xFFFF:
        raise ValueError(
            f"tile_id_precision BITS16 cannot address {num_tiles} tiles; use "
            "TileIdPrecision.BITS32")
    statics = dict(width=width, height=height, tile_w=tile_w, tile_h=tile_h,
                   near_plane=near_plane, far_plane=far_plane)
    chain_kw = dict(capacity=capacity, tiles_x=tiles_x, tiles_y=tiles_y,
                    sh_degree=sh_degree, alpha_threshold=alpha_threshold,
                    total_ink_threshold=total_ink_threshold,
                    input_is_srgb=input_is_srgb,
                    mode="mono" if exact_tile_test else "none", **statics)
    if not exact_tile_test or max_per_tile > 0:
        # rows narrow exact-tested rects only, and JAX takes its XLA
        # binning (no rows) under a clamp
        row_capacity = 0
    if depth_key_bits == 16:
        srt, packed, slot_total, overflow = d16_packed_sorted(
            gi, view, proj, center, prepared,
            key_plan=d16_key_plan(num_tiles, gi.count), **chain_kw)
        entry_words = packed.words
    else:
        key_plan = None
        if row_capacity > 0:
            key_plan = _mono_key_statics(gi.count, row_capacity=row_capacity,
                                         **statics)
        if key_plan is None:
            # no rows without a row-addressing plan, as in JAX; with no
            # plan at all, the stable fallback
            row_capacity = 0
            key_plan = _mono_key_statics(gi.count, **statics)
        srt, packed, entry_words, slot_total, overflow = mono_packed_sorted(
            gi, view, proj, center, prepared, key_plan=key_plan,
            row_capacity=row_capacity, **chain_kw)
    counts = srt.counts
    if max_per_tile > 0:
        counts = torch.clamp(counts, max=max_per_tile)
        total_instances = visible_rect_total(packed.rect_word, packed.rect_h,
                                             packed.visible)
    else:
        total_instances = counts.sum().to(torch.int32)
    color, depth = blend_image(srt.key, entry_words, srt.idx_bits, srt.starts,
                               counts, tiles_x=tiles_x, tiles_y=tiles_y,
                               width=width, height=height, tile_w=tile_w,
                               tile_h=tile_h, depth_mode=depth_mode,
                               r2_cutoff=r2_cutoff)
    header = FrameHeader(
        visible_count=packed.visible.sum().to(torch.int32),
        total_instances=total_instances,
        overflow=overflow,
        slot_total=slot_total,
        row_total=(_row_demand(packed.rect_word, packed.rect_h)
                   if exact_tile_test else None),
    )
    return RenderOutput(color=color, depth=depth, header=header)


def depth_first_stereo_frame(gi, views, projs, centers, scene_transform,
                             prepared=None, *, width: int, height: int,
                             capacity: int, sh_degree: int,
                             alpha_threshold: float,
                             total_ink_threshold: float, near_plane: float,
                             far_plane: float, input_is_srgb: bool,
                             tile_w: int = 16, tile_h: int = 16,
                             depth_mode: str = "weighted") -> RenderOutput:
    """One side-by-side stereo DepthFirst frame on the device of ``gi``:
    one shared instance list over the union of both eyes' tile rects, the
    dual-eye q <= 9 tile test at expansion, and a single-pass dual-eye blend
    with alpha zeroed past q = 9, composited into an (H, 2W) image
    (``depth_mode`` "normalized" is the Hardware renderer's).
    ``views``/``projs`` (2, 4, 4), ``centers`` (2, 3) and
    ``scene_transform`` (4, 4) are host arrays.  The header's
    ``total_instances`` is the union-rect total of the visible gaussians;
    ``row_total`` is None.  Tiles: each side 1 to 4096 pixels."""
    check_tile(tile_w, tile_h)
    tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
    num_tiles = tiles_x * tiles_y
    key_plan = B.make_key_plan(num_tiles, gi.count, near_plane=near_plane,
                               far_plane=far_plane)
    (keys, entry_words, slot_total, overflow, visible_count,
     total_live) = _stereo_packed_ops(
            gi, views, projs, centers, scene_transform, prepared, key_plan,
            width=width, height=height, capacity=capacity, tiles_x=tiles_x,
            sh_degree=sh_degree, alpha_threshold=alpha_threshold,
            total_ink_threshold=total_ink_threshold, near_plane=near_plane,
            far_plane=far_plane, input_is_srgb=input_is_srgb, tile_w=tile_w,
            tile_h=tile_h)
    srt = sort_and_ranges(keys, key_plan, num_tiles)
    color, depth = blend_image(srt.key, entry_words, srt.idx_bits, srt.starts,
                               srt.counts, tiles_x=tiles_x, tiles_y=tiles_y,
                               width=width, height=height, tile_w=tile_w,
                               tile_h=tile_h, n_eyes=2,
                               r2_cutoff=STEREO_R2_CUTOFF,
                               depth_mode=depth_mode)
    header = FrameHeader(visible_count=visible_count,
                         total_instances=total_live, overflow=overflow,
                         slot_total=slot_total)
    return RenderOutput(color=color, depth=depth, header=header)


def _stereo_packed_ops(gi, views, projs, centers, scene_transform, prepared,
                       key_plan, *, width, height, capacity, tiles_x,
                       sh_degree, alpha_threshold, total_ink_threshold,
                       near_plane, far_plane, input_is_srgb, tile_w, tile_h):
    """Dual-eye projection + stereo prep / expand up to the sort operands.
    Returns (the keys, the 8 entry word rows, slot_total, overflow,
    visible_count, total_live = the union-rect total of the visible
    gaussians)."""
    pp = stereo_project_and_cull_packed(
        gi, views, projs, centers, scene_transform, prepared=prepared,
        width=width, height=height, tile_w=tile_w, tile_h=tile_h,
        sh_degree=sh_degree, near_plane=near_plane, far_plane=far_plane,
        alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb,
        key_plan=key_plan)
    keys, entry_words, slot_total, overflow = binning_sort_operands(
        pp, capacity=capacity, tiles_x=tiles_x, key_plan=key_plan,
        mode="stereo", tile_w=tile_w, tile_h=tile_h)
    return (keys, entry_words, slot_total, overflow,
            pp.visible.sum().to(torch.int32),
            visible_rect_total(pp.rect_word, pp.rect_h, pp.visible))


def foveated_rects(pp, inv_fit, *, tiles_x: int, tiles_y: int,
                   tile_w: int = 16, tile_h: int = 16):
    """Re-bin a dual-eye projection made at the display size onto the
    physical tile grid of a foveated target.

    Each union pixel bound goes through the degree-9 inverse-warp fit
    ``inv_fit`` (2, 13) of :func:`~gsm_renderer_tpu_torch.stereo.
    foveated_raster_tables` (Horner in float32, in the JAX order, with true
    divisions), widened by the fit's error margin, floored to physical tiles
    and clamped to the grid.  Returns (min_tx, max_tx, min_ty, max_ty) int32,
    ``visible`` (the projection's, and a non-empty rect) and ``rect_count``
    (int32, 0 where not visible)."""
    fit = np.asarray(inv_fit, np.float32)

    def inv_map(v, axis):
        row = fit[axis]
        t = M.div(v - float(row[10]), float(row[11] - row[10])) * 2.0 - 1.0
        acc = torch.full_like(t, float(row[0]))
        for k in range(1, 10):
            acc = acc * t + float(row[k])
        return acc, float(row[12])

    def tile(v, size, n_tiles):
        return torch.clamp(torch.floor(v * (1.0 / size)).to(torch.int32), 0,
                           n_tiles - 1)

    sx0, mx = inv_map(pp.px_min, 0)
    sx1, _ = inv_map(pp.px_max, 0)
    sy0, my = inv_map(pp.py_min, 1)
    sy1, _ = inv_map(pp.py_max, 1)
    min_tx = tile(sx0 - mx, tile_w, tiles_x)
    max_tx = tile(sx1 + mx, tile_w, tiles_x)
    min_ty = tile(sy0 - my, tile_h, tiles_y)
    max_ty = tile(sy1 + my, tile_h, tiles_y)
    visible = pp.visible & (min_tx <= max_tx) & (min_ty <= max_ty)
    rect_count = torch.where(visible, (max_tx - min_tx + 1) * (max_ty - min_ty + 1),
                             0).to(torch.int32)
    return (min_tx, max_tx, min_ty, max_ty), visible, rect_count


def foveated_packed(pp, inv_fit, *, tiles_x: int, tiles_y: int,
                    tile_w: int = 16, tile_h: int = 16):
    """The prep input of a foveated frame: ``pp`` (a display-size
    :class:`StereoPackedProjection`) with its rect word, rect_h and
    visibility replaced by the physical rects of :func:`foveated_rects`
    (CULLED_BIT where not visible, rect_h 0 there).  Returns (that
    projection, the re-binned rect counts)."""
    (min_tx, max_tx, min_ty, _), visible, rect_count = foveated_rects(
        pp, inv_fit, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h)
    rect_w = max_tx - min_tx + 1
    rect_word = u32(B.pack_rect_word(min_tx, min_ty, rect_w))
    rect_word = torch.where(visible, rect_word, rect_word | CULLED_BIT)
    rect_h = torch.div(rect_count, torch.clamp(rect_w, min=1),
                       rounding_mode="floor").to(torch.int32)
    return dataclasses.replace(pp, rect_word=M.to_i32(rect_word),
                               rect_h=rect_h, visible=visible), rect_count


def _foveated_packed_ops(gi, views, projs, centers, scene_transform, prepared,
                         key_plan, tables, *, display_width, display_height,
                         capacity, tiles_x, tiles_y, sh_degree,
                         alpha_threshold, total_ink_threshold, near_plane,
                         far_plane, input_is_srgb, tile_w, tile_h,
                         foveated_lod):
    """Dual-eye projection at the display size, re-binning onto the
    physical tiles, warped prep / expand up to the sort operands.  Returns
    (the keys, the 8 entry word rows, slot_total, overflow,
    visible_count = the projection's visible gaussians, total_live = the
    re-binned rect total)."""
    pp = stereo_project_and_cull_packed(
        gi, views, projs, centers, scene_transform, prepared=prepared,
        width=display_width, height=display_height, tile_w=tile_w,
        tile_h=tile_h, sh_degree=sh_degree, near_plane=near_plane,
        far_plane=far_plane, alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb,
        key_plan=key_plan)
    warped, rect_count = foveated_packed(pp, tables["inv_fit"],
                                         tiles_x=tiles_x, tiles_y=tiles_y,
                                         tile_w=tile_w, tile_h=tile_h)
    keys, entry_words, slot_total, overflow = binning_sort_operands(
        warped, capacity=capacity, tiles_x=tiles_x, key_plan=key_plan,
        mode="warped", tile_w=tile_w, tile_h=tile_h,
        warped_bounds=tables["bounds"], lod_min=foveated_lod)
    return (keys, entry_words, slot_total, overflow,
            pp.visible.sum().to(torch.int32), rect_count.sum().to(torch.int32))


def depth_first_stereo_foveated_frame(
        gi, views, projs, centers, scene_transform, tables, prepared=None, *,
        display_width: int, display_height: int, render_width: int,
        render_height: int, capacity: int, sh_degree: int,
        alpha_threshold: float, total_ink_threshold: float, near_plane: float,
        far_plane: float, input_is_srgb: bool, tile_w: int = 16,
        tile_h: int = 16, foveated_lod: float = 0.0,
        depth_mode: str = "weighted") -> RenderOutput:
    """One foveated stereo frame on the device of ``gi``, rasterized
    directly into the (render_height, 2 * render_width) physical target.

    ``tables``: :func:`foveated_device_tables` of the target at this
    frame's tile (``inv_fit`` on the host, ``coord_x``, ``coord_y`` and
    ``bounds`` on the device); ``depth_mode`` "normalized" is the Hardware
    renderer's.  The KeyPlan addresses the physical tiles; the header's
    ``visible_count`` counts the projection's visible gaussians before
    re-binning and ``total_instances`` is the re-binned rect total.  Tiles:
    each side 1 to 4096 pixels (the physical grid within 127 tiles an
    axis, as in JAX)."""
    check_tile(tile_w, tile_h)
    if tables["coord_x"].shape[1] != tile_w * tile_h:
        raise ValueError(f"the foveated tables are for {tables['coord_x'].shape[1]}"
                         f"-pixel tiles, the frame's tile is {tile_w}x{tile_h}")
    tiles_x, tiles_y = cfg.tiles_for(render_width, render_height, tile_w, tile_h)
    num_tiles = tiles_x * tiles_y
    key_plan = B.make_key_plan(num_tiles, gi.count, near_plane=near_plane,
                               far_plane=far_plane)
    (keys, entry_words, slot_total, overflow, visible_count,
     total_live) = _foveated_packed_ops(
            gi, views, projs, centers, scene_transform, prepared, key_plan,
            tables, display_width=display_width,
            display_height=display_height, capacity=capacity,
            tiles_x=tiles_x, tiles_y=tiles_y, sh_degree=sh_degree,
            alpha_threshold=alpha_threshold,
            total_ink_threshold=total_ink_threshold, near_plane=near_plane,
            far_plane=far_plane, input_is_srgb=input_is_srgb, tile_w=tile_w,
            tile_h=tile_h, foveated_lod=foveated_lod)
    srt = sort_and_ranges(keys, key_plan, num_tiles)
    color, depth = blend_image(srt.key, entry_words, srt.idx_bits, srt.starts,
                               srt.counts, tiles_x=tiles_x, tiles_y=tiles_y,
                               width=render_width, height=render_height,
                               tile_w=tile_w, tile_h=tile_h, n_eyes=2,
                               r2_cutoff=STEREO_R2_CUTOFF,
                               pixel_coords=(tables["coord_x"],
                                             tables["coord_y"]),
                               depth_mode=depth_mode)
    header = FrameHeader(visible_count=visible_count,
                         total_instances=total_live, overflow=overflow,
                         slot_total=slot_total)
    return RenderOutput(color=color, depth=depth, header=header)


def foveated_device_tables(target, device, tile_w: int = 16,
                           tile_h: int = 16) -> dict:
    """The raster tables of a foveated target for frames on ``device`` at
    ``tile_w`` x ``tile_h`` tiles: ``inv_fit`` (host numpy), ``coord_x``,
    ``coord_y`` and ``bounds`` (tensors on the device).  Built once per
    device and tile and cached on the target."""
    cache = target.__dict__.setdefault("_torch_tabs", {})
    key = (str(torch.device(device)), tile_w, tile_h)
    tabs = cache.get(key)
    if tabs is None:
        host = foveated_raster_tables(target, tile_w, tile_h)
        tabs = dict(inv_fit=host["inv_fit"])
        for name in ("coord_x", "coord_y", "bounds"):
            tabs[name] = torch.from_numpy(host[name]).to(device)
        cache[key] = tabs
    return tabs


class DepthFirstRenderer(GaussianRenderer):
    """Flagship renderer: depth-ordered tile lists from one instance sort."""

    _mono_key = "df"
    _stereo_key = "df_stereo"
    #: the frame settings the Hardware renderer overrides: the mono
    #: capacity factor (None: the config's), the exact per-tile test, the
    #: blend's per-pixel cutoff (0: none) and the depth every frame writes
    _mono_capacity_factor: int | None = None
    _exact_tile_test = True
    _r2_cutoff = 0.0
    _depth_mode = "weighted"

    def render(self, gi, camera, width: int, height: int) -> RenderOutput:
        return _mono_render(self, gi, camera, width, height)

    def render_stereo(self, gi, camera, width: int,
                      height: int) -> RenderOutput:
        """Side-by-side stereo: ``camera`` a :class:`StereoCameraParams`;
        returns an (H, 2W) frame, the left eye first."""
        return _stereo_render(self, gi, camera, width, height)

    def render_stereo_foveated(self, gi, camera, target) -> RenderOutput:
        """Foveated stereo: ``camera`` a :class:`StereoCameraParams`,
        ``target`` a :class:`~gsm_renderer_tpu_torch.stereo.
        FoveatedStereoTarget`.  Rasterizes directly into the reduced-rate
        physical target and returns a (render_height, 2 * render_width)
        frame, the left eye first (``stereo.expand_foveated`` resamples it
        to the display)."""
        return _stereo_foveated_render(self, gi, camera, target)

    def render_stereo_foveated_compress(self, gi, camera,
                                        target) -> RenderOutput:
        """The render-full-then-compress foveated path: a full-resolution
        stereo frame resampled into the physical target (kept for
        comparison)."""
        out = self.render_stereo(gi, camera, target.display_width,
                                 target.display_height)
        depth = compress_foveated(out.depth[..., None], target)[..., 0]
        return RenderOutput(color=compress_foveated(out.color, target),
                            depth=depth, header=out.header)


def _mono_render(self, gi, camera, width, height):
    """The mono frame.  Stereo and foveated frames take neither key
    precision, as in JAX, and render the same frame under any."""
    self.validate_inputs(gi, width, height)
    c = self.config
    n = gi.count
    tile_w, tile_h = cfg.DEPTH_FIRST_TILE
    depth_key_bits = c.depth_sort_key_precision.value
    # depth_first_frame falls back to the full-rect path when the
    # row-addressing KeyPlan does not fit; 16-bit depth keys and full rects
    # run without rows, as in JAX
    row_cap = (self.pick_row_capacity(n, kind=self._mono_key)
               if c.row_expand and depth_key_bits == 32
               and self._exact_tile_test else 0)
    sh_degree = used_sh_degree(c, gi)
    out = depth_first_frame(
        gi, camera.view_matrix, camera.projection_matrix, camera.position,
        cached_projection_inputs(gi, sh_degree),
        width=width, height=height,
        capacity=self.pick_capacity(n, self._mono_capacity_factor,
                                    kind=self._mono_key),
        sh_degree=sh_degree, alpha_threshold=c.alpha_threshold,
        total_ink_threshold=c.total_ink_threshold,
        near_plane=camera.near_plane, far_plane=camera.far_plane,
        input_is_srgb=c.gaussian_color_space == cfg.GaussianColorSpace.SRGB,
        tile_w=tile_w, tile_h=tile_h,
        depth_mode=self._depth_mode if c.depth_output else "none",
        row_capacity=row_cap, tile_id_bits=c.tile_id_precision.value,
        depth_key_bits=depth_key_bits, exact_tile_test=self._exact_tile_test,
        r2_cutoff=self._r2_cutoff)
    self.note_frame(n, out.header, kind=self._mono_key)
    return self.finalize_output(out)


def _stereo_rig(camera):
    """(views (2, 4, 4), projs (2, 4, 4), centers (2, 3), scene transform
    (4, 4)) host arrays of a StereoCameraParams."""
    left, right = camera.left, camera.right
    st = (np.eye(4, dtype=np.float32) if camera.scene_transform is None
          else np.asarray(camera.scene_transform, np.float32))
    return (np.stack([left.view_matrix, right.view_matrix]),
            np.stack([left.projection_matrix, right.projection_matrix]),
            np.stack([left.position, right.position]), st)


def _stereo_render(self, gi, camera, width, height):
    self.validate_inputs(gi, width, height)
    c = self.config
    n = gi.count
    left = camera.left
    sh_degree = used_sh_degree(c, gi)
    out = depth_first_stereo_frame(
        gi, *_stereo_rig(camera), cached_projection_inputs(gi, sh_degree),
        width=width, height=height,
        # union rects are expanded in full (the dual-eye test prunes them)
        capacity=self.pick_capacity(n, cfg.FULL_RECT_CAPACITY_FACTOR,
                                    kind=self._stereo_key),
        sh_degree=sh_degree, alpha_threshold=c.alpha_threshold,
        total_ink_threshold=c.total_ink_threshold,
        near_plane=left.near_plane, far_plane=left.far_plane,
        input_is_srgb=c.gaussian_color_space == cfg.GaussianColorSpace.SRGB,
        depth_mode=self._depth_mode)
    self.note_frame(n, out.header, kind=self._stereo_key)
    return self.finalize_output(out)


def _stereo_foveated_render(self, gi, camera, target):
    self.validate_inputs(gi, target.display_width, target.display_height)
    c = self.config
    n = gi.count
    left = camera.left
    sh_degree = used_sh_degree(c, gi)
    kind = self._stereo_key + "_fov"
    out = depth_first_stereo_foveated_frame(
        gi, *_stereo_rig(camera), foveated_device_tables(target, self.device),
        cached_projection_inputs(gi, sh_degree),
        display_width=target.display_width,
        display_height=target.display_height,
        render_width=target.render_width, render_height=target.render_height,
        # re-binned union rects are expanded in full (the warped dual-eye
        # test prunes them)
        capacity=self.pick_capacity(n, cfg.FULL_RECT_CAPACITY_FACTOR,
                                    kind=kind),
        sh_degree=sh_degree, alpha_threshold=c.alpha_threshold,
        total_ink_threshold=c.total_ink_threshold,
        near_plane=left.near_plane, far_plane=left.far_plane,
        input_is_srgb=c.gaussian_color_space == cfg.GaussianColorSpace.SRGB,
        foveated_lod=c.foveated_lod, depth_mode=self._depth_mode)
    self.note_frame(n, out.header, kind=kind)
    return self.finalize_output(out)
