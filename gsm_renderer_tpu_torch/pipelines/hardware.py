"""HardwareRenderer: depth-sorted splatting without per-tile tests.

Port of ``gsm_renderer_tpu/pipelines/hardware.py`` (``hardware_frame`` and
``HardwareRenderer``).  The reference rasterizes screen-space quads in
globally depth-sorted order with fixed-function blending; the JAX package,
and this one, reproduce its semantics with the DepthFirst frame:

* an instance for every tile of a visible gaussian's clamped rect, with no
  per-tile test (a rasterized quad covers its whole rect): prep and the
  expand in mode "none", at ``FULL_RECT_CAPACITY_FACTOR``;
* alpha zeroed per pixel where q > ``R2_CUTOFF`` (the fragment discard);
* alpha-normalized depth, sum(w * d) / max(alpha, 1e-6).

Stereo and foveated stereo are the DepthFirst frames with normalized depth.
``hardware_backend`` (MESH_SHADERS / INSTANCED) picks only the JAX blend's
``blocks_per_dma``, a TPU DMA granularity with no counterpart here, and
``back_to_front`` gives the same radiance as front-to-back compositing
(JAX ``depth_first_frame`` drops it): both render the same frame.
"""

from __future__ import annotations

from .. import config as cfg
from .depth_first import DepthFirstRenderer, depth_first_frame

#: fragment discard radius^2
R2_CUTOFF = 9.0


def hardware_frame(gi, view, proj, center, prepared=None, **statics):
    """One Hardware mono frame: :func:`depth_first_frame` with full rects,
    the per-pixel r^2 <= 9 cutoff and normalized depth (``back_to_front``,
    which it takes too, renders the same frame)."""
    return depth_first_frame(gi, view, proj, center, prepared,
                             exact_tile_test=False, depth_mode="normalized",
                             r2_cutoff=R2_CUTOFF, **statics)


class HardwareRenderer(DepthFirstRenderer):
    """Hardware-rasterization-equivalent renderer (mesh and instanced
    backends alike): mono, stereo, foveated stereo and its compress
    variant, with full-rect instances, the r^2 <= 9 cutoff and normalized
    depth."""

    _mono_key = "hw"
    _stereo_key = "hw_stereo"
    _mono_capacity_factor = cfg.FULL_RECT_CAPACITY_FACTOR
    _exact_tile_test = False
    _r2_cutoff = R2_CUTOFF
    _depth_mode = "normalized"
