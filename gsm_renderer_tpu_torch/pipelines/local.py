"""LocalRenderer: per-tile lists in 16-bit depth order, 16x16 tiles, a
fixed per-tile capacity and first-hit depth.

Port of ``gsm_renderer_tpu/pipelines/local.py`` (``local_frame`` on its
Pallas path and ``LocalRenderer.render``).  The frame is the Global
renderer's chain on 16x16 tiles
(:func:`~gsm_renderer_tpu_torch.pipelines.common.d16_packed_sorted`), then:

* each tile's count is clamped to ``max_per_tile`` in the ranges' counts
  pass (the reference drops the instances past its fixed per-tile
  capacity); the starts are unchanged, the dropped instances still count
  in ``slot_total``, and ``total_instances`` is the clamped counts' sum;
* the blend's depth is the first hit's: the depth of the first record with
  alpha > 0.1, 0 where none.

Mono only, as in JAX.
"""

from __future__ import annotations

from functools import partial

from .. import config as cfg
from ..kernels.expand import check_tile
from ..profiling import traced_frame
from ..types import RenderOutput
from .base import GaussianRenderer
from .common import d16_key_plan, d16_packed_sorted, frame_output


def local_frame(gi, view, proj, center, prepared=None, *, width: int,
                height: int, capacity: int, sh_degree: int,
                alpha_threshold: float, total_ink_threshold: float,
                near_plane: float, far_plane: float, input_is_srgb: bool,
                tile_w: int = 16, tile_h: int = 16,
                max_per_tile: int = cfg.LOCAL_MAX_PER_TILE) -> RenderOutput:
    """One Local frame on the device of ``gi``.  ``view``/``proj`` (4, 4)
    and ``center`` (3,) are host arrays.  The header's ``total_instances``
    is the sum of the clamped tile counts.  Tiles: each side 1 to 4096
    pixels."""
    check_tile(tile_w, tile_h)
    tiles_x, tiles_y = cfg.tiles_for(width, height, tile_w, tile_h)
    num_tiles = tiles_x * tiles_y
    if num_tiles > 0xFFFF:
        raise ValueError(f"LocalRenderer tile id must fit 16 bits ({num_tiles})")
    srt, packed, slot_total, overflow, sums = d16_packed_sorted(
        gi, view, proj, center, prepared,
        key_plan=d16_key_plan(num_tiles, gi.count), width=width, height=height,
        capacity=capacity, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h, sh_degree=sh_degree, alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, near_plane=near_plane,
        far_plane=far_plane, input_is_srgb=input_is_srgb,
        max_per_tile=max_per_tile)
    return frame_output(
        srt, packed.words, sums, slot_total=slot_total, overflow=overflow,
        capacity=capacity, tiles_x=tiles_x, tiles_y=tiles_y, width=width,
        height=height, tile_w=tile_w, tile_h=tile_h, depth_mode="first_hit")


class LocalRenderer(GaussianRenderer):
    """Per-tile 16-bit-key renderer, 16x16 tiles, at most
    ``LOCAL_MAX_PER_TILE`` instances a tile, first-hit depth (mono only)."""

    _mono_key = "local"

    @traced_frame
    def render(self, gi, camera, width: int, height: int) -> RenderOutput:
        tile_w, tile_h = cfg.LOCAL_TILE
        kw = dict(width=width, height=height, near_plane=camera.near_plane,
                  far_plane=camera.far_plane, tile_w=tile_w, tile_h=tile_h,
                  max_per_tile=cfg.LOCAL_MAX_PER_TILE)
        return self.render_frame(
            self._mono_key, gi, width, height,
            partial(local_frame, gi, camera.view_matrix,
                    camera.projection_matrix, camera.position), kw)
