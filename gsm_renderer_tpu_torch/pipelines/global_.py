"""GlobalRenderer: one global (tile, depth16) sort, 32x16 tiles.

Port of ``gsm_renderer_tpu/pipelines/global_.py`` (``global_frame`` on its
Pallas path, ``d16_packed_sorted``, and ``GlobalRenderer.render``).  The
frame is the DepthFirst machinery with no depth pre-sort: the projection
emits the 16-bit half-depth key, slots are emitted in gaussian order, and
one sort orders them by (tile, depth16, gaussian index)
(:func:`~gsm_renderer_tpu_torch.pipelines.common.d16_packed_sorted`); the
blend composites 32x16 tiles with weighted depth.  Mono only, as in JAX.
``global_frame(exact_tile_test=False)`` expands every tile of a visible
gaussian's clamped rect (prep and the expand in mode "none") under the same
order: JAX's XLA binning of full rects under its fused [tile:16 |
depth16:16] key, sorted stably.
"""

from __future__ import annotations

from functools import partial

from .. import config as cfg
from ..kernels.expand import check_tile
from ..profiling import traced_frame
from ..types import RenderOutput
from .base import GaussianRenderer
from .common import d16_key_plan, d16_packed_sorted, frame_output


def global_frame(gi, view, proj, center, prepared=None, *, width: int,
                 height: int, capacity: int, sh_degree: int,
                 alpha_threshold: float, total_ink_threshold: float,
                 near_plane: float, far_plane: float, input_is_srgb: bool,
                 tile_w: int = 32, tile_h: int = 16,
                 exact_tile_test: bool = True,
                 back_to_front: bool = False) -> RenderOutput:
    """One Global frame on the device of ``gi``: weighted depth always (the
    JAX frame takes no depth mode; like it, the frame and the renderer
    ignore ``back_to_front``: both blend orders give the same radiance).
    ``view``/``proj`` (4, 4) and ``center`` (3,) are host arrays.
    ``exact_tile_test=False``: full-rect instances, no per-tile test.  The
    header's ``total_instances`` is the sum of the tile counts.  Tiles:
    each side 1 to 4096 pixels."""
    del back_to_front
    check_tile(tile_w, tile_h)
    tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
    num_tiles = tiles_x * tiles_y
    if num_tiles > 0xFFFF:
        raise ValueError("GlobalRenderer tile id must fit 16 bits "
                         f"({num_tiles} tiles)")
    srt, packed, slot_total, overflow, sums = d16_packed_sorted(
        gi, view, proj, center, prepared,
        key_plan=d16_key_plan(num_tiles, gi.count), width=width, height=height,
        capacity=capacity, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h, sh_degree=sh_degree, alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, near_plane=near_plane,
        far_plane=far_plane, input_is_srgb=input_is_srgb,
        mode="mono" if exact_tile_test else "none")
    return frame_output(
        srt, packed.words, sums, slot_total=slot_total, overflow=overflow,
        capacity=capacity, tiles_x=tiles_x, tiles_y=tiles_y, width=width,
        height=height, tile_w=tile_w, tile_h=tile_h)


class GlobalRenderer(GaussianRenderer):
    """Global (tile, depth16) single-sort renderer, 32x16 tiles (mono
    only)."""

    _mono_key = "global"

    @traced_frame
    def render(self, gi, camera, width: int, height: int) -> RenderOutput:
        tile_w, tile_h = cfg.GLOBAL_TILE
        kw = dict(width=width, height=height, near_plane=camera.near_plane,
                  far_plane=camera.far_plane, tile_w=tile_w, tile_h=tile_h)
        return self.render_frame(
            self._mono_key, gi, width, height,
            partial(global_frame, gi, camera.view_matrix,
                    camera.projection_matrix, camera.position), kw)
