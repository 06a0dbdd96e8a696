"""Plain PyTorch reference of the side-by-side stereo frame: two eyes of
``width`` x ``height`` on one full-rate tile grid, into an (H, 2W) image,
the left eye first.

The frame is the one ``render.py``'s module docstring describes, stereo,
on the mono frame's grid: each eye's 16x16 tiles cover the pixel rect
[16 tx, 16 tx + 16] x [16 ty, 16 ty + 16], and pixel (x, y) is sampled at
(x, y), the integer pixel corner, as in the mono frame.  A gaussian's tiles
are the union of its two eyes' tile rects (each eye's 3-sigma box clamped
to the screen, as the mono frame's rect); a tile keeps it where either
eye's quantized ellipse reaches q <= 9 inside the tile's pixel rect; each
eye composites the shared list with alpha zeroed past q = 9 in that eye.
Projection, records and compositing are ``render.Reference``'s own.

Why not ``Reference.stereo`` with a rate-1 foveated target:
``foveation.target(width, height, min_rate=1.0, ...)`` samples pixel i at
i + 0.5 and puts tile boundaries at 16 k + 0.5, half a pixel off this grid.

Departures from the upstream's stereo equations (``renderStereo``, side by
side), each as the renderer under test makes it:

- the upstream writes every tile of the union rect without a test; here a
  tile keeps a gaussian only where either eye reaches q <= 9 in it.  Alpha
  is zeroed past q = 9 in both, so a dropped tile held only zero-alpha
  composites; what moves is where the 256-rank batches fall, which the
  exit's slack covers (``render.py``);
- the upstream blends into an rgba16Float array; here colour and depth are
  float32 (the renderer's default output);
- as in ``render.py``, a tile's records are taken in batches of 256 ranks
  and the tile stops once every pixel of both eyes is under 1/255.

The arithmetic is ``dtype``'s (float32; bfloat16 for the control), with
TF32 off.  Imports nothing of the renderer.
"""

from __future__ import annotations

import torch

from .render import STEREO_Q_CUTOFF, Frame, _min_q


def _tile_span(lo, hi, size: int, tile: int, tiles: int):
    """Inclusive tile span of the pixel interval [lo, hi], clamped to the
    screen as ``render.Eye.tile_rect`` clamps one eye's box."""
    lo = torch.clamp(lo, 0.0, size - 1.0).float()
    hi = torch.clamp(hi, 0.0, size - 1.0).float()
    return (torch.floor(lo / tile).long().clamp(min=0),
            (torch.ceil(hi / tile).long() - 1).clamp(max=tiles - 1))


def stereo(ref, rig, width: int, height: int) -> Frame:
    """The side-by-side frame of ``rig`` (two camera dicts, left first) of
    ``width`` x ``height`` an eye, by ``ref`` (a ``render.Reference``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = ref.tile
    tiles_x, tiles_y = -(-width // t), -(-height // t)
    g = ref._project_stereo(rig, width, height)
    # the union of the eyes' boxes (each clamped to [0, size]) gives the
    # union of their tile rects
    x0, x1, y0, y1 = g["box"]
    g["rect"] = (*_tile_span(x0, x1, width, t, tiles_x),
                 *_tile_span(y0, y1, height, t, tiles_y))
    recs = g["recs"]

    def tests(i, tx, ty):
        px0, py0 = (tx * t).to(ref.dtype), (ty * t).to(ref.dtype)
        q = torch.minimum(_min_q(recs[0], px0, px0 + t, py0, py0 + t, i),
                          _min_q(recs[1], px0, px0 + t, py0, py0 + t, i))
        return q <= STEREO_Q_CUTOFF

    gid, counts, tested = ref._bin(g, tiles_x, tiles_y, tests)

    def sample(tx, ty):
        p = torch.arange(t * t, device=ref.device)
        return ((tx * t)[:, None] + p % t).float(), \
            ((ty * t)[:, None] + torch.div(p, t, rounding_mode="floor")).float()

    color, depth, counts_b = ref._composite(recs, gid, counts, tiles_x,
                                            tiles_y, sample, STEREO_Q_CUTOFF)
    color, depth = ref._assemble(color, depth, tiles_x, tiles_y, width, height)
    visible = int(g["ok"].sum())
    return Frame(color, depth[..., 0], visible, dict(
        gaussians=ref.n, visible=visible, pairs=int(gid.shape[0]),
        pairs_tested=tested, pixels=2 * width * height, eyes=2, **counts_b),
        depth[..., 1], depth[..., 2])
