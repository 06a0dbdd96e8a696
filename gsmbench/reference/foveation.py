"""The foveated target, worked out again from its definition (NumPy, host).

A foveated stereo target of a display ``width`` x ``height`` has one rate
per display column and one per display row (a rasterization rate map): full
rate within ``radius`` of the gaze centre, falling quadratically to
``min_rate`` at the far screen edge.  The physical target has
ceil(sum of rates) pixels an axis; physical pixel i samples the display
coordinate where the cumulative rate reaches (i + 0.5) * total / n, found
by linear interpolation of the cumulative sum.  Physical tiles past the
physical edge continue the last step.

The renderer bins each gaussian onto the physical tile grid by the display
rect of each physical tile (its boundaries' display coordinates) and
evaluates each physical pixel at its display coordinate.
"""

from __future__ import annotations

import numpy as np


def rate_axis(n: int, centre: float, min_rate: float, radius: float):
    t = (np.arange(n) + 0.5) / n
    d = np.abs(t - centre)
    edge = max(max(centre, 1.0 - centre) - radius, 1e-6)
    fall = np.clip((d - radius) / edge, 0.0, 1.0)
    return (1.0 - (1.0 - min_rate) * fall ** 2).astype(np.float32)


def sample_positions(rate) -> np.ndarray:
    """Display coordinate of each physical pixel along one axis."""
    n_out = int(np.ceil(rate.sum()))
    cum = np.concatenate([[0.0], np.cumsum(rate)])
    want = (np.arange(n_out) + 0.5) * (cum[-1] / n_out)
    return np.interp(want, cum, np.arange(len(cum))).astype(np.float32)


def extend(pos, n: int) -> np.ndarray:
    """``pos`` continued by its last step to ``n`` entries."""
    step = pos[-1] - pos[-2] if len(pos) > 1 else 1.0
    extra = pos[-1] + step * np.arange(1, n - len(pos) + 1)
    return np.concatenate([pos, extra]).astype(np.float32)


def target(width: int, height: int, min_rate: float, radius: float,
           tile_w: int, tile_h: int, centre=(0.5, 0.5)) -> dict:
    """Everything the reference needs of a foveated target: the physical
    size an eye, the tile grid, each physical pixel's display coordinate
    (``px`` along x, ``py`` along y, padded to whole tiles) and each
    physical tile boundary's display coordinate (``bx``, ``by``)."""
    xs = sample_positions(rate_axis(width, centre[0], min_rate, radius))
    ys = sample_positions(rate_axis(height, centre[1], min_rate, radius))
    tiles_x, tiles_y = -(-len(xs) // tile_w), -(-len(ys) // tile_h)
    px = extend(xs, tiles_x * tile_w)
    py = extend(ys, tiles_y * tile_h)
    bx = extend(px, (tiles_x + 1) * tile_w + 1)[np.arange(tiles_x + 1) * tile_w]
    by = extend(py, (tiles_y + 1) * tile_h + 1)[np.arange(tiles_y + 1) * tile_h]
    return dict(render_width=len(xs), render_height=len(ys), tiles_x=tiles_x,
                tiles_y=tiles_y, px=px, py=py, bx=bx.astype(np.float32),
                by=by.astype(np.float32))
