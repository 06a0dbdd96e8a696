"""LocalRenderer: per-tile lists in 16-bit depth order, 16x16 tiles, a
fixed per-tile capacity and first-hit depth.

Port of ``gsm_renderer_tpu/pipelines/local.py`` (``local_frame`` on its
Pallas path and ``LocalRenderer.render``).  The frame is the Global
renderer's chain on 16x16 tiles
(:func:`~gsm_renderer_tpu_torch.pipelines.common.d16_packed_sorted`), then:

* each tile's count is clamped to ``max_per_tile`` (the reference drops the
  instances past its fixed per-tile capacity); the starts are unchanged,
  and the dropped instances still count in ``slot_total``;
* the blend's depth is the first hit's: the depth of the first record with
  alpha > 0.1, 0 where none.

Mono only, as in JAX.
"""

from __future__ import annotations

import torch

from .. import config as cfg
from ..kernels.blend import blend_image
from ..kernels.expand import check_tile
from ..types import FrameHeader, RenderOutput
from .base import GaussianRenderer
from .common import d16_frame_kwargs, d16_key_plan, d16_packed_sorted


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
    srt, packed, slot_total, overflow = d16_packed_sorted(
        gi, view, proj, center, prepared,
        key_plan=d16_key_plan(num_tiles, gi.count), width=width, height=height,
        capacity=capacity, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h, sh_degree=sh_degree, alpha_threshold=alpha_threshold,
        total_ink_threshold=total_ink_threshold, near_plane=near_plane,
        far_plane=far_plane, input_is_srgb=input_is_srgb)
    counts = torch.clamp(srt.counts, max=max_per_tile)
    color, depth = blend_image(srt.key, packed.words, srt.idx_bits, srt.starts,
                               counts, tiles_x=tiles_x, tiles_y=tiles_y,
                               width=width, height=height, tile_w=tile_w,
                               tile_h=tile_h, depth_mode="first_hit")
    header = FrameHeader(visible_count=packed.visible.sum().to(torch.int32),
                         total_instances=counts.sum().to(torch.int32),
                         overflow=overflow, slot_total=slot_total)
    return RenderOutput(color=color, depth=depth, header=header)


class LocalRenderer(GaussianRenderer):
    """Per-tile 16-bit-key renderer, 16x16 tiles, at most
    ``LOCAL_MAX_PER_TILE`` instances a tile, first-hit depth (mono only)."""

    _mono_key = "local"

    def render(self, gi, camera, width: int, height: int) -> RenderOutput:
        self.validate_inputs(gi, width, height)
        out = local_frame(
            gi, camera.view_matrix, camera.projection_matrix, camera.position,
            tile_w=cfg.LOCAL_TILE[0], tile_h=cfg.LOCAL_TILE[1],
            max_per_tile=cfg.LOCAL_MAX_PER_TILE,
            **d16_frame_kwargs(self, gi, camera, width, height))
        self.note_frame(gi.count, out.header, kind=self._mono_key)
        return self.finalize_output(out)
