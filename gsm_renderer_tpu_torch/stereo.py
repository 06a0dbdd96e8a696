"""Foveated stereo targets: rate maps, warp tables, the physical raster
tables, and the resamples between the physical and the display image.

Port of ``gsm_renderer_tpu/stereo.py``.  The JAX module imports
``jax.numpy`` at the top, so this package keeps its own copy of the host
code: :class:`FoveatedStereoTarget`, :func:`make_rate_maps`,
:func:`warp_tables` and :func:`foveated_raster_tables` are the same NumPy
functions.  :func:`compress_foveated` and :func:`expand_foveated` are
bilinear resamples in PyTorch on the device of their input; their index
tables are built on the host, as in JAX.

A foveated frame rasterizes directly into the reduced-rate physical target
(``render_height`` x ``render_width`` per eye): each physical pixel samples
the display-space coordinate the warp tables give it, so the blend shades
only physical pixels (``DepthFirstRenderer.render_stereo_foveated``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FoveatedStereoTarget:
    """Per-axis rate maps plus the display size (the reference's
    ``FoveatedStereoDrawable``)."""

    display_width: int
    display_height: int
    rate_x: np.ndarray  # (display_width,) relative sample density in (0, 1]
    rate_y: np.ndarray  # (display_height,)

    @property
    def render_width(self) -> int:
        return int(np.ceil(self.rate_x.sum()))

    @property
    def render_height(self) -> int:
        return int(np.ceil(self.rate_y.sum()))


def make_rate_maps(width: int, height: int, center=(0.5, 0.5),
                   min_rate: float = 0.35, radius: float = 0.35
                   ) -> FoveatedStereoTarget:
    """Gaussian-falloff foveation: full rate inside ``radius`` (fractional) of
    the gaze center, smoothly dropping to ``min_rate`` at the edges."""
    def axis(n, c):
        t = (np.arange(n) + 0.5) / n
        d = np.abs(t - c)
        # fall reaches 1 at the far screen edge
        edge = max(max(c, 1.0 - c) - radius, 1e-6)
        fall = np.clip((d - radius) / edge, 0.0, 1.0)
        return (1.0 - (1.0 - min_rate) * fall ** 2).astype(np.float32)

    return FoveatedStereoTarget(
        display_width=width, display_height=height,
        rate_x=axis(width, center[0]), rate_y=axis(height, center[1]))


def warp_tables(target: FoveatedStereoTarget):
    """Monotone sample-position tables: (x_table (render_width,), y_table
    (render_height,)), the display coordinate each physical pixel samples
    (the inverse of the cumulative rate integral)."""
    def table(rate, n_out):
        cum = np.concatenate([[0.0], np.cumsum(rate)])  # screen pos -> sample idx
        total = cum[-1]
        want = (np.arange(n_out) + 0.5) * (total / n_out)
        return np.interp(want, cum, np.arange(len(cum))).astype(np.float32)

    return (table(target.rate_x, target.render_width),
            table(target.rate_y, target.render_height))


def foveated_raster_tables(target: FoveatedStereoTarget, tile_w: int = 16,
                           tile_h: int = 16):
    """Host tables for rasterizing directly into the physical target.

    Returns a dict of numpy arrays:
      ``coord_x`` (tiles_x_phys, P): display-space x of every physical pixel,
        laid out per tile (P = tile_w * tile_h, row-major within the tile);
      ``coord_y`` (tiles_y_phys, P): display-space y per physical tile row;
      ``lut_x_lo`` / ``lut_x_hi`` (tiles_x_disp,), ``lut_y_lo`` /
        ``lut_y_hi``: the physical-tile range each display tile covers;
      ``bounds`` (2, 128) float32: the display coordinate of each physical
        tile boundary per axis, padded with 1e9 (the grid must fit 127 tiles
        per axis);
      ``inv_fit`` (2, 13) float32: per axis the degree-9 polynomial of the
        inverse warp (display coordinate -> physical sample index) in
        normalized t = x / size * 2 - 1, then 0, the size and the fit's
        error margin.
    """
    xt, yt = warp_tables(target)  # physical index -> display coordinate
    rw, rh = target.render_width, target.render_height
    txp = -(-rw // tile_w)
    typ = -(-rh // tile_h)
    p = tile_w * tile_h

    def pad_table(t, n):
        # continue the last step past the physical edge: padded pixels
        # sample just outside the display (alpha 0 there)
        step = t[-1] - t[-2] if len(t) > 1 else 1.0
        extra = t[-1] + step * np.arange(1, n - len(t) + 1)
        return np.concatenate([t, extra]).astype(np.float32)

    xt_pad = pad_table(xt, txp * tile_w)
    yt_pad = pad_table(yt, typ * tile_h)
    coord_x = np.empty((txp, p), np.float32)
    for t in range(txp):
        coord_x[t] = np.tile(xt_pad[t * tile_w:(t + 1) * tile_w], tile_h)
    coord_y = np.empty((typ, p), np.float32)
    for t in range(typ):
        coord_y[t] = np.repeat(yt_pad[t * tile_h:(t + 1) * tile_h], tile_w)

    def luts(t_pad, n_phys, tile, n_disp_tiles, disp_size):
        inv = np.interp(np.arange(disp_size + 1, dtype=np.float64),
                        t_pad, np.arange(len(t_pad)))
        lo = np.empty(n_disp_tiles, np.int32)
        hi = np.empty(n_disp_tiles, np.int32)
        n_tiles_phys = -(-n_phys // tile)
        for t in range(n_disp_tiles):
            p0 = inv[min(t * tile, disp_size)]
            p1 = inv[min((t + 1) * tile, disp_size)]
            lo[t] = max(int(np.floor(p0)) // tile, 0)
            hi[t] = min(int(np.ceil(p1) - 1) // tile, n_tiles_phys - 1)
        return lo, hi

    tiles_x_disp = -(-target.display_width // tile_w)
    tiles_y_disp = -(-target.display_height // tile_h)
    lut_x_lo, lut_x_hi = luts(xt_pad, rw, tile_w, tiles_x_disp,
                              target.display_width)
    lut_y_lo, lut_y_hi = luts(yt_pad, rh, tile_h, tiles_y_disp,
                              target.display_height)

    # one 128-entry row per axis: the expand's tile test and the prep's
    # window masks index it directly
    if txp + 1 > 128 or typ + 1 > 128:
        raise ValueError("foveated physical tile grid must fit 127 tiles/axis")

    def bound_row(t_pad, n_tiles, tile):
        ext = pad_table(t_pad, (n_tiles + 1) * tile + 1)
        row = np.full(128, 1e9, np.float32)
        row[:n_tiles + 1] = ext[np.arange(n_tiles + 1) * tile]
        return row

    bound_x = bound_row(xt_pad, txp, tile_w)
    bound_y = bound_row(yt_pad, typ, tile_h)

    # inverse warp for the per-gaussian re-binning of display pixel bounds
    # (kept tight: tile-granular LUTs would round every rect out first)
    def inv_fit(t_pad, disp_size):
        xs = np.arange(disp_size + 1, dtype=np.float64)
        ys = np.interp(xs, t_pad, np.arange(len(t_pad), dtype=np.float64))
        t = (xs / disp_size) * 2.0 - 1.0
        coeffs = np.polyfit(t, ys, 9)
        margin = np.abs(np.polyval(coeffs, t) - ys).max() + 1e-3
        return np.concatenate([coeffs, [0.0, float(disp_size),
                                        float(margin)]]).astype(np.float32)

    fit = np.stack([inv_fit(xt_pad, target.display_width),
                    inv_fit(yt_pad, target.display_height)])
    return dict(coord_x=coord_x, coord_y=coord_y,
                lut_x_lo=lut_x_lo, lut_x_hi=lut_x_hi,
                lut_y_lo=lut_y_lo, lut_y_hi=lut_y_hi,
                bounds=np.stack([bound_x, bound_y]),
                inv_fit=fit)


def _bilinear(img, iy, ix, fy, fx):
    """Bilinear sample of ``img`` (H, W, C) at rows iy(+1), columns ix(+1)
    with weights fy (h, 1, 1), fx (1, w, 1)."""
    def g(yy, xx):
        return img[yy][:, xx]

    return (g(iy, ix) * (1 - fx) * (1 - fy)
            + g(iy, ix + 1) * fx * (1 - fy)
            + g(iy + 1, ix) * (1 - fx) * fy
            + g(iy + 1, ix + 1) * fx * fy)


def compress_foveated(full, target: FoveatedStereoTarget, stereo: bool = True):
    """Resample a full-resolution (H, n_eyes * W, C) render into the
    reduced-rate physical target (the reference's fullscreen copy pass with
    a rasterization rate map attached)."""
    xt, yt = warp_tables(target)
    h, w = full.shape[:2]
    n_eyes = 2 if stereo else 1
    eye_w = w // n_eyes
    dev = full.device
    sx = np.clip(xt, 0, eye_w - 1.001)
    sy = np.clip(yt, 0, h - 1.001)
    ix = np.floor(sx).astype(np.int32)
    iy = np.floor(sy).astype(np.int32)
    fx = torch.from_numpy(sx - ix.astype(np.float32)).to(dev)[None, :, None]
    fy = torch.from_numpy(sy - iy.astype(np.float32)).to(dev)[:, None, None]
    ix = torch.from_numpy(ix.astype(np.int64)).to(dev)
    iy = torch.from_numpy(iy.astype(np.int64)).to(dev)
    return torch.cat([_bilinear(full[:, e * eye_w:(e + 1) * eye_w], iy, ix,
                                fy, fx) for e in range(n_eyes)], dim=1)


def expand_foveated(intermediate, target: FoveatedStereoTarget,
                    stereo: bool = True):
    """Resample the (render_h, n_eyes * render_w, C) physical image to the
    display target (the vertex-amplified fullscreen copy with a rate map
    attached)."""
    xt, yt = warp_tables(target)
    h, w = intermediate.shape[:2]
    n_eyes = 2 if stereo else 1
    eye_w = w // n_eyes
    # a tile-aligned render may exceed the rate-map integral size; the warp
    # tables only address the first render_width/height texels
    use_w = min(eye_w, target.render_width)
    use_h = min(h, target.render_height)
    dev = intermediate.device

    # display pixel -> intermediate coordinate (inverse of the warp tables)
    disp_x = np.interp(np.arange(target.display_width) + 0.5, xt,
                       np.arange(len(xt))).astype(np.float32)
    disp_y = np.interp(np.arange(target.display_height) + 0.5, yt,
                       np.arange(len(yt))).astype(np.float32)
    ix = np.clip(np.floor(disp_x).astype(np.int32), 0, use_w - 2)
    iy = np.clip(np.floor(disp_y).astype(np.int32), 0, use_h - 2)
    fx = torch.from_numpy(disp_x - ix.astype(np.float32)).to(dev)[None, :, None]
    fy = torch.from_numpy(disp_y - iy.astype(np.float32)).to(dev)[:, None, None]
    ix = torch.from_numpy(ix.astype(np.int64)).to(dev)
    iy = torch.from_numpy(iy.astype(np.int64)).to(dev)
    return torch.cat([_bilinear(intermediate[:, e * eye_w:(e + 1) * eye_w],
                                iy, ix, fy, fx) for e in range(n_eyes)], dim=1)
