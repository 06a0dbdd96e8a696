"""DepthFirstRenderer: the flagship pipeline, mono.

Port of ``gsm_renderer_tpu/pipelines/depth_first.py`` (``depth_first_frame``
on its packed path with ``row_capacity=0``, ``DepthFirstRenderer.render`` and
``_mono_render``).  A frame is

  1. project + cull + quantize + pack        kernels/project.py   (kernel 1)
  2. binning prep: masks, counts, scan       kernels/expand.py    (kernel 2)
  3. slot expansion into KeyPlan keys        kernels/expand.py    (kernel 3)
  4. unstable instance sort on an int64 key  pipelines/common.py  (torch.sort)
  5. tile ranges                             ops/binning.py       (searchsorted)
  6. blend + assemble                        kernels/blend.py     (kernel 4)

with no host read except the capacity lock-in (pipelines/base.py).  Options
that are not ported yet raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from .. import config as cfg
from ..kernels.blend import blend_image
from ..kernels.expand import CULLED_BIT, MASK_H, MASK_W
from ..kernels.project import cached_projection_inputs, project_and_cull_packed
from ..mathlib import u32
from ..ops import binning as B
from ..types import FrameHeader, RenderOutput
from .base import GaussianRenderer
from .common import binning_sort_operands, binning_sorted_tile, sort_instances


def not_ported(what: str, item: str):
    """The error for an option of the JAX package that this package does not
    implement yet; ``item`` names its ROADMAP.md entry."""
    return NotImplementedError(
        f"{what} is not ported to gsm_renderer_tpu_torch yet (ROADMAP.md: {item})")


def _row_demand(rect_word, rect_h):
    """Virtual-row demand of the per-row decomposition (one row per
    mask-eligible or culled gaussian, ``rect_h`` per oversized rect); the
    header reports it every frame, as the JAX package does."""
    rw = u32(rect_word)
    visible = (rw & CULLED_BIT) == 0
    rect_w = (rw >> 20) & 0x3FF
    oversized = visible & ((rect_w > MASK_W) | (rect_h > MASK_H))
    return torch.where(oversized, rect_h, 1).sum().to(torch.int32)


def depth_first_frame(gi, view, proj, center, prepared=None, *, width: int,
                      height: int, capacity: int, sh_degree: int,
                      alpha_threshold: float, total_ink_threshold: float,
                      near_plane: float, far_plane: float,
                      input_is_srgb: bool, tile_w: int = 16, tile_h: int = 16,
                      depth_mode: str = "weighted") -> RenderOutput:
    """One mono DepthFirst frame on the device of ``gi``.  ``view``/``proj``
    (4, 4) and ``center`` (3,) are host arrays; ``prepared`` an optional
    cached (comp, harm) projection layout."""
    tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
    num_tiles = tiles_x * tiles_y
    if num_tiles > 0xFFFF:
        raise ValueError(
            f"tile_id_precision BITS16 cannot address {num_tiles} tiles; use "
            "TileIdPrecision.BITS32")
    key_plan = B.make_key_plan(num_tiles, gi.count, near_plane=near_plane,
                               far_plane=far_plane)
    if key_plan is None:
        raise not_ported("the stable-sort fallback (no tie-free KeyPlan fits)",
                         "Queue 1, Global and Local renderers")

    packed = project_and_cull_packed(
        gi, view, proj, center, prepared=prepared, width=width, height=height,
        tile_w=tile_w, tile_h=tile_h, sh_degree=sh_degree,
        near_plane=near_plane, far_plane=far_plane,
        alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, input_is_srgb=input_is_srgb,
        key_plan=key_plan)
    (key1, key2, words), slot_total, overflow = binning_sort_operands(
        packed, capacity=capacity, tiles_x=tiles_x, key_plan=key_plan,
        tile_w=tile_w, tile_h=tile_h, alpha_threshold=alpha_threshold)
    sorted_key, table = sort_instances(key1, key2, words)
    sorted_tile = binning_sorted_tile(sorted_key, plan_tuple=key_plan.kernel_tuple)
    starts, counts = B.extract_tile_ranges(sorted_tile, num_tiles)
    color, depth = blend_image(table, starts, counts, tiles_x=tiles_x,
                               tiles_y=tiles_y, width=width, height=height,
                               depth_mode=depth_mode)
    header = FrameHeader(
        visible_count=packed.visible.sum().to(torch.int32),
        total_instances=counts.sum().to(torch.int32),
        overflow=overflow,
        slot_total=slot_total,
        row_total=_row_demand(packed.rect_word, packed.rect_h),
    )
    return RenderOutput(color=color, depth=depth, header=header)


class DepthFirstRenderer(GaussianRenderer):
    """Flagship renderer: depth-ordered tile lists from one instance sort."""

    _mono_key = "df"

    def render(self, gi, camera, width: int, height: int) -> RenderOutput:
        return _mono_render(self, gi, camera, width, height)

    def render_stereo(self, gi, camera, width, height):
        raise not_ported("side-by-side stereo", "Queue 1, side-by-side stereo")

    def render_stereo_foveated(self, gi, camera, target):
        raise not_ported("foveated stereo", "Queue 1, foveated stereo")


def _mono_render(self, gi, camera, width, height):
    self.validate_inputs(gi, width, height)
    c = self.config
    if c.row_expand:
        raise not_ported("row_expand=True (pass row_expand=False)",
                         "Queue 2, row_expand_pallas")
    if c.depth_sort_key_precision != cfg.DepthSortKeyPrecision.BITS32:
        raise not_ported("depth_sort_key_precision=BITS16",
                         "Queue 1, Global and Local renderers")
    if c.tile_id_precision != cfg.TileIdPrecision.BITS16:
        raise not_ported("tile_id_precision=BITS32",
                         "Queue 1, Global and Local renderers")
    n = gi.count
    sh_degree = min(c.sh_degree, {1: 0, 4: 1, 9: 2, 16: 3}[gi.sh_n_coeffs])
    out = depth_first_frame(
        gi, camera.view_matrix, camera.projection_matrix, camera.position,
        cached_projection_inputs(gi, sh_degree),
        width=width, height=height,
        capacity=self.pick_capacity(n, kind=self._mono_key),
        sh_degree=sh_degree, alpha_threshold=c.alpha_threshold,
        total_ink_threshold=c.total_ink_threshold,
        near_plane=camera.near_plane, far_plane=camera.far_plane,
        input_is_srgb=c.gaussian_color_space == cfg.GaussianColorSpace.SRGB,
        tile_w=cfg.DEPTH_FIRST_TILE[0], tile_h=cfg.DEPTH_FIRST_TILE[1],
        depth_mode="weighted" if c.depth_output else "none")
    self.note_frame(n, out.header, kind=self._mono_key)
    return self.finalize_output(out)


class _NotPortedRenderer(GaussianRenderer):
    _item = ""

    def __init__(self, *args, **kwargs):
        raise not_ported(type(self).__name__, self._item)


class GlobalRenderer(_NotPortedRenderer):
    _item = "Queue 1, Global and Local renderers"


class LocalRenderer(_NotPortedRenderer):
    _item = "Queue 1, Global and Local renderers"


class HardwareRenderer(_NotPortedRenderer):
    _item = "Queue 1, HardwareRenderer"
