"""Tile blending (front-to-back alpha compositing) and image assembly.

Port of ``gsm_renderer_tpu/kernels/blend.py``: ``blend_tiles_pallas``
(``_row_blend_kernel``, depth modes "weighted", "none", "first_hit" and
"normalized", ``n_eyes`` 1 and 2, ``r2_cutoff``, ``pixel_coords``,
``tile_row_offset``, tiles of 1 to 4096 pixels a side) and
``assemble_image``.  The
kernel is ``csrc/blend.cu``; it writes the (H, W, 4) image and the (H, W)
depth directly -- (H, 2W) for two eyes side by side -- so assembly is fused
into it on the card.  A tile whose sides are not 8, 16 or 32 pixels
takes the kernel's split layout (:func:`split_layout`); a tile of more than
``CLUSTER_MAX_PIXELS`` pixels is shared by CTAs without a cluster, which
blend to their own exits and then resume to the tile's, the tiles with the
most records launched first (scratch and order made here:
:func:`large_operands`).

Records through the sorted keys: the blend takes the sorted int64 instance
keys and the entry table's word rows (``entry_words``: 4 * n_eyes (N,) int32
tensors, or a (4 * n_eyes, N) tensor -- the projection's words, or a row
table's).  Rank k composites entry ``sorted_key[k] & (2**idx_bits - 1)`` (the
KeyPlan index field).  The JAX package gathers the words into sorted order
after the sort; here nothing does: the kernel reads the records it
composites through the index.  A table already in sorted order is blended
through the identity key, ``sorted_key = arange(C)`` with ``idx_bits = 32``.

``pixel_coords`` = (coord_x (tiles_x, P), coord_y (tiles_y, P)) float32, P =
tile_w * tile_h, is the foveated frame's: pixel p of tile (tx, ty) evaluates
the gaussians at
the display-space point (coord_x[tx, p], coord_y[ty, p]) instead of its own
integer corner (``stereo.foveated_raster_tables``).

Depth mode "first_hit" (the Local renderer's): a pixel's depth is that of
the first record whose alpha -- after the 0.99 clamp -- exceeds
``FIRST_HIT_ALPHA``, 0 where none does; the pixel keeps compositing until
its tile exits, so a hit after it saturated still counts.  Depth mode
"normalized" (the Hardware renderer's) divides the weighted depth by the
pixel's alpha: sum(w * d) / max(1 - T, 1e-6), T the final transmittance.
Pixel p of a tile is (p % tile_w, p // tile_w); the kernel blends every
pairing of eyes, cutoff, depth mode and pixel coordinates at every tile.

``tile_row_offset`` is a band frame's: the raster's tile row t samples
the frame's pixel rows of tile row t + tile_row_offset and is written to
the raster's own rows (``parallel/multichip.py``).

Early-exit rule, shared by the kernel and :func:`blend_tiles_plain`: a tile's
span is walked in 256-record batches aligned to 128-record blocks (the Pallas
kernel's 2 x 128-slot chunks), whatever the tile's size (the kernel stages a
batch in rounds where a tile has fewer than 256 pixels); after each batch
the tile stops once every
pixel's transmittance is below 1/255 -- in both eyes, for the dual-eye blend
(the Pallas kernel's exit on the larger of the eyes' transmittances).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _native
from .. import mathlib as M
from .expand import THETA_UNIT, _f16_bits_to_f32, _u8f, check_tile

MIN_TRANSMITTANCE = 1.0 / 255.0
ALPHA_CLAMP = 0.99
#: first_hit depth: the first record with alpha above this
FIRST_HIT_ALPHA = 0.1
#: gsm_blend's depth_mode codes
DEPTH_MODES = {"none": 0, "weighted": 1, "first_hit": 2, "normalized": 3}
#: normalized depth: the weighted depth over max(alpha, NORMALIZED_MIN_ALPHA)
NORMALIZED_MIN_ALPHA = 1e-6
WORD_ROWS = 4
#: the plain version's stacked record fields: the means, the linear forms'
#: x and y coefficients and the colour side by side, so that a pair of
#: fields takes one op
FIELDS = ("mx", "my", "a1", "a2", "b1", "b2", "r", "g", "b", "logop", "depth")
BATCH = 256
BLOCK = 128
#: the most pixels a tile holds on the kernel's one-CTA and cluster paths;
#: a larger tile takes the large-tile path
CLUSTER_MAX_PIXELS = 4096

BLEND = _native.Kernel("blend", "blend", "gsm_blend", [
    _native.P, _native.I, _native.P, _native.I, _native.P, _native.P,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.F, _native.F, _native.F, _native.F,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P])


def split_layout(n_eyes: int, r2_cutoff: float, tile_w: int, tile_h: int):
    """(warp_w, warps a CTA, CTAs a tile, 1 where records are culled by warp
    else 0) of the kernel's split layout for a tile, or None for a tile the
    8x4-block instances take: csrc/blend.cu's ``gsm_blend_layout``, host
    code that needs no card (the library is built on first use)."""
    fn = _native.load("blend").gsm_blend_layout
    fn.argtypes = [_native.I, _native.F, _native.I, _native.I,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    got = fn(n_eyes, M.f32(r2_cutoff), tile_w, tile_h, out)
    if got < 0:
        raise ValueError(f"gsm_blend_layout refuses {n_eyes} eyes, r2_cutoff "
                         f"{r2_cutoff}, tile {tile_w}x{tile_h}")
    return tuple(out) if got else None


def large_operands(tile_w: int, tile_h: int, counts, width: int, height: int,
                   n_eyes: int, r2_cutoff: float):
    """The large-tile path's operands, None for a tile of at most
    CLUSTER_MAX_PIXELS pixels: (exits, int32, each tile's exit rank then
    each CTA's own, the CTAs a tile from :func:`split_layout`; state,
    int32 (height, n_eyes * width, 2), the resumed pixels' transmittance
    and depth; order, int32, the tiles by record count, the most first:
    the order they are launched in)."""
    if tile_w * tile_h <= CLUSTER_MAX_PIXELS:
        return None
    ctas = split_layout(n_eyes, r2_cutoff, tile_w, tile_h)[2]
    dev = counts.device
    return (torch.empty(counts.shape[0] * (1 + ctas), dtype=torch.int32,
                        device=dev),
            torch.empty((height, n_eyes * width, 2), dtype=torch.int32,
                        device=dev),
            torch.argsort(counts, descending=True,
                         stable=True).to(torch.int32))


def _check_depth_mode(depth_mode: str) -> None:
    if depth_mode not in DEPTH_MODES:
        raise NotImplementedError(f"depth_mode {depth_mode!r} is not ported yet")


def _check_words(entry_words, n_eyes: int) -> list:
    if n_eyes not in (1, 2):
        raise ValueError(f"n_eyes must be 1 or 2, got {n_eyes}")
    words = list(entry_words)
    if len(words) != WORD_ROWS * n_eyes:
        raise ValueError(f"{n_eyes} eye(s) read {WORD_ROWS * n_eyes} word rows, "
                         f"got {len(words)}")
    return words


def entry_index(sorted_key, idx_bits: int):
    """Entry index (int64) of each sorted instance: the low ``idx_bits``
    bits of the sort key (of key2)."""
    return sorted_key & ((1 << idx_bits) - 1)


def decode_records(words):
    """Per-record blend attributes of 4 word rows: the centred linear forms
    (a1, b1, a2, b2), mean, log opacity, color and depth (float32, one per
    column)."""
    w0, w1, w2, w3 = (M.u32(words[k]) for k in range(WORD_ROWS))
    theta = (w1 & 0xFFFF).to(torch.int32).to(torch.float32) * THETA_UNIT
    s1 = torch.clamp(_f16_bits_to_f32(w1 >> 16), min=1e-4)
    s2 = torch.clamp(_f16_bits_to_f32(w2), min=1e-4)
    cth = torch.cos(theta)
    sth = torch.sin(theta)
    i1 = 1.0 / s1
    i2 = 1.0 / s2
    return dict(mx=_f16_bits_to_f32(w0), my=_f16_bits_to_f32(w0 >> 16),
                depth=_f16_bits_to_f32(w2 >> 16), r=_u8f(w3, 0),
                g=_u8f(w3, 8), b=_u8f(w3, 16), logop=torch.log(_u8f(w3, 24)),
                a1=cth * i1, b1=sth * i1, a2=-sth * i2, b2=cth * i2)


def blend_tiles_plain(sorted_key, entry_words, idx_bits: int, starts, counts,
                      *, tiles_x: int, tile_w: int = 16, tile_h: int = 16,
                      depth_mode: str = "weighted", n_eyes: int = 1,
                      r2_cutoff: float = 0.0, tiles=None, pixel_coords=None,
                      tile_row_offset: int = 0,
                      return_processed: bool = False):
    """Plain version of the blend kernel on any device.

    ``sorted_key``: (C,) int64 sorted instance keys; ``entry_words``: the
    4 * n_eyes word rows of the entry table (left eye first), read at
    :func:`entry_index`; ``starts``/``counts``: (T,) int32 tile spans over
    the sorted ranks; ``tiles``: optional subset of tile ids (default all);
    ``pixel_coords``: optional foveated (coord_x, coord_y) tables (see the
    module docstring); ``tile_row_offset``: the frame's tile row of tile
    row 0 (a band's first row; pixel rows sit at (t_y + tile_row_offset) *
    tile_h + ly).  With ``r2_cutoff`` > 0 alpha is zeroed where q >
    r2_cutoff.  Returns (tile_color (T', P, 4), tile_depth (T', P) or
    None), P = tile_w * tile_h, for one eye, a list of such pairs for two,
    plus the number of records each tile composited before its exit when
    ``return_processed``.  Records are composited one rank at a time across
    all tiles, each tile stopping by the kernel's rule.
    """
    _check_depth_mode(depth_mode)
    words = _check_words(entry_words, n_eyes)
    _check_row_offset(tile_row_offset, pixel_coords)
    dev = sorted_key.device
    if tiles is None:
        tiles = torch.arange(starts.shape[0], device=dev)
    tiles = tiles.to(torch.int64)
    pix = tile_w * tile_h
    # each eye's FIELDS stacked, so that a rank's records gather in one op
    fields = [torch.stack([rec[name] for name in FIELDS]) for rec in (
        decode_records(words[WORD_ROWS * e:WORD_ROWS * (e + 1)])
        for e in range(n_eyes))]
    # ranks outside every span (dead slots) may carry any index
    entry = torch.clamp(entry_index(sorted_key, idx_bits), 0,
                        max(words[0].shape[0] - 1, 0))
    cap = sorted_key.shape[0]
    start = starts.to(torch.int64)[tiles]
    count = counts.to(torch.int64)[tiles]
    base = torch.div(start, BLOCK, rounding_mode="floor") * BLOCK
    # rank start + k ends a batch (start + k + 1 - base a multiple of
    # BATCH) where k % BATCH is the tile's phase
    phase = torch.remainder(base - start - 1, BATCH)
    t_x = tiles % tiles_x
    t_y = torch.div(tiles, tiles_x, rounding_mode="floor")
    if pixel_coords is not None:
        pxa = pixel_coords[0].to(torch.float32)[t_x]
        pya = pixel_coords[1].to(torch.float32)[t_y]
    else:
        pidx = torch.arange(pix, device=dev)
        lx = (pidx % tile_w).to(torch.float32)
        ly = torch.div(pidx, tile_w, rounding_mode="floor").to(torch.float32)
        pxa = lx[None, :] + (t_x * tile_w).to(torch.float32)[:, None]
        pya = ly[None, :] + ((t_y + tile_row_offset)
                             * tile_h).to(torch.float32)[:, None]
    pxy = torch.stack([pxa, pya])

    n_t = tiles.shape[0]
    trans = [torch.ones((n_t, pix), dtype=torch.float32, device=dev)
             for _ in range(n_eyes)]
    # colour (3, T', P) and depth (T', P) of each eye
    rgb = [torch.zeros((3, n_t, pix), dtype=torch.float32, device=dev)
           for _ in range(n_eyes)]
    acc_d = [torch.zeros((n_t, pix), dtype=torch.float32, device=dev)
             for _ in range(n_eyes)]
    first_hit = depth_mode == "first_hit"
    hit = [torch.zeros((n_t, pix), dtype=torch.bool, device=dev)
           for _ in range(n_eyes)]
    active = count > 0
    processed = torch.zeros(n_t, dtype=torch.int64, device=dev)
    max_k = int(count.max()) if n_t else 0
    for k in range(max_k):
        # once every tile has exited or run out of records the remaining
        # ranks composite nothing: stop (checked once a batch)
        if k % BATCH == 0 and not bool((active & (k < count)).any()):
            break
        valid = active & (k < count)
        g = entry[torch.clamp(start + k, 0, max(cap - 1, 0))]
        for e, stacked in enumerate(fields):
            f = stacked[:, g, None]  # FIELDS of each tile's record
            d = pxy - f[0:2]  # dx, dy
            uv = f[2:4] * d[0] + f[4:6] * d[1]  # u = a1 dx + b1 dy, v
            sq = uv * uv
            q = sq[0] + sq[1]
            alpha = torch.clamp(torch.exp(q * -0.5 + f[9]), max=ALPHA_CLAMP)
            if r2_cutoff > 0.0:
                alpha = torch.where(q > r2_cutoff, 0.0, alpha)
            alpha = torch.where(valid[:, None], alpha, 0.0)
            w = alpha * trans[e]
            rgb[e] = rgb[e] + w * f[6:9]
            if first_hit:
                took = ~hit[e] & (alpha > FIRST_HIT_ALPHA)
                acc_d[e] = torch.where(took, f[10], acc_d[e])
                hit[e] = hit[e] | took
            else:
                acc_d[e] = acc_d[e] + w * f[10]
            trans[e] = trans[e] * (1.0 - alpha)
        processed += valid.to(torch.int64)
        batch_end = valid & (phase == k % BATCH) & (k + 1 < count)
        tmax = trans[0]
        for t in trans[1:]:
            tmax = torch.maximum(tmax, t)
        saturated = (tmax < MIN_TRANSMITTANCE).all(dim=1)
        active = active & ~(batch_end & saturated)
    eyes = []
    for c, a, t in zip(rgb, acc_d, trans):
        alpha = 1.0 - t
        depth = None if depth_mode == "none" else a
        if depth_mode == "normalized":
            depth = depth / torch.clamp(alpha, min=NORMALIZED_MIN_ALPHA)
        eyes.append((torch.stack([c[0], c[1], c[2], alpha], dim=-1), depth))
    out = eyes[0] if n_eyes == 1 else eyes
    if return_processed:
        return (*out, processed) if n_eyes == 1 else (out, processed)
    return out


def _check_row_offset(tile_row_offset: int, pixel_coords) -> None:
    if tile_row_offset < 0 or (tile_row_offset and pixel_coords is not None):
        raise ValueError("a tile row offset is >= 0 and takes no pixel "
                         f"coordinate tables, got {tile_row_offset}")


def assemble_image(tile_color, tile_depth, *, tiles_x: int, tiles_y: int,
                   width: int, height: int, tile_w: int = 16, tile_h: int = 16):
    """(T, P, C) tile rasters -> (H, W, C) image + (H, W) depth."""
    def unpack(t, ch):
        x = t.reshape(tiles_y, tiles_x, tile_h, tile_w, ch).permute(0, 2, 1, 3, 4)
        return x.reshape(tiles_y * tile_h, tiles_x * tile_w, ch)[:height, :width]

    color = unpack(tile_color, 4).contiguous()
    if tile_depth is None:
        return color, None
    return color, unpack(tile_depth[..., None], 1)[..., 0].contiguous()


def blend_image_cuda(sorted_key, entry_words, idx_bits: int, starts, counts,
                     *, tiles_x: int, tiles_y: int, width: int, height: int,
                     tile_w: int = 16, tile_h: int = 16,
                     depth_mode: str = "weighted", n_eyes: int = 1,
                     r2_cutoff: float = 0.0, pixel_coords=None,
                     tile_row_offset: int = 0):
    """Launch ``csrc/blend.cu``: returns (color (H, n_eyes * W, 4), depth
    (H, n_eyes * W) or None), the eyes side by side.  The kernel blends one
    or two eyes without a cutoff (``r2_cutoff`` 0) or with one, in every
    depth mode, with or without pixel coordinates, at every tile of 1 to
    4096 pixels a side.  It raises on a negative cutoff."""
    _check_depth_mode(depth_mode)
    words = _check_words(entry_words, n_eyes)
    _check_row_offset(tile_row_offset, pixel_coords)
    if not r2_cutoff >= 0.0:
        raise NotImplementedError(
            f"the blend kernel takes r2_cutoff >= 0 (0: no cutoff), got "
            f"{r2_cutoff}")
    check_tile(tile_w, tile_h, "blend kernel")
    if not 1 <= idx_bits <= 32:
        raise ValueError(f"idx_bits must lie in [1, 32], got {idx_bits}")
    dev = sorted_key.device
    n_t = tiles_x * tiles_y
    _native.check(sorted_key, "sorted_key", torch.int64, (sorted_key.shape[0],),
                  dev)
    for k, w in enumerate(words):
        _native.check(w, f"entry_words[{k}]", torch.int32, (words[0].shape[0],),
                      dev)
    _native.check(starts, "starts", torch.int32, (n_t,), dev)
    _native.check(counts, "counts", torch.int32, (n_t,), dev)
    coords = (None, None)
    if pixel_coords is not None:
        for name, t, rows in (("coord_x", pixel_coords[0], tiles_x),
                              ("coord_y", pixel_coords[1], tiles_y)):
            _native.check(t, name, torch.float32, (rows, tile_w * tile_h),
                          dev)
        coords = tuple(_native.ptr(t) for t in pixel_coords)
    with_depth = depth_mode != "none"
    color = torch.empty((height, n_eyes * width, 4), dtype=torch.float32,
                        device=dev)
    depth = torch.empty((height, n_eyes * width) if with_depth else (1,),
                        dtype=torch.float32, device=dev)
    large = large_operands(tile_w, tile_h, counts, width, height, n_eyes,
                           r2_cutoff)
    BLEND.launch(_native.ptr(sorted_key), idx_bits, _native.ptr_array(words),
                 len(words), _native.ptr(starts), _native.ptr(counts), tiles_x,
                 tiles_y, width, height, tile_row_offset, tile_w, tile_h,
                 DEPTH_MODES[depth_mode], M.f32(THETA_UNIT),
                 M.f32(1.0 / 255.0), M.f32(MIN_TRANSMITTANCE),
                 M.f32(r2_cutoff), *coords, _native.ptr(color),
                 _native.ptr(depth),
                 *((None,) * 3 if large is None else map(_native.ptr, large)))
    return color, (depth if with_depth else None)


#: the most blend launches a frame makes (the large-tile path: two)
MAX_OUTPUT_NODES = 4


def find_output_nodes(graph: int, color):
    """The blend launches of a captured frame's CUDA graph (``graph``: its
    ``cudaGraph_t``, which they read and must outlive) that write the
    colour tensor ``color``: (an opaque buffer, their number) for
    :func:`set_outputs`.  Raises RuntimeError where there is none."""
    size = _native.c_entry("blend", "gsm_output_node_bytes", ctypes.c_size_t,
                           ())
    nodes = ctypes.create_string_buffer(size() * MAX_OUTPUT_NODES)
    count = ctypes.c_int(0)
    err = _native.c_entry("blend", "gsm_output_nodes", argtypes=(
        _native.P, _native.P, _native.P, _native.I, _native.P))(
            graph, _native.ptr(color), nodes, MAX_OUTPUT_NODES,
            ctypes.addressof(count))
    if err != 0:
        raise RuntimeError(f"gsm_output_nodes: CUDA error {err}: no blend "
                           "launch of the graph writes the colour")
    return nodes, count.value


def set_outputs(graph_exec: int, nodes, color, depth=None) -> None:
    """Point the blend launches ``nodes`` (:func:`find_output_nodes`) of
    the instantiated graph ``graph_exec`` (its ``cudaGraphExec_t``) at
    ``color`` and, where given, ``depth``, for the graph's next launches;
    launches already queued keep theirs."""
    buf, count = nodes
    err = _native.c_entry("blend", "gsm_set_outputs", argtypes=(
        _native.P, _native.P, _native.I, _native.P, _native.P))(
            graph_exec, buf, count, _native.ptr(color),
            _native.ptr_or_null(depth))
    if err != 0:
        raise RuntimeError(f"gsm_set_outputs: CUDA error {err}")


def blend_image(sorted_key, entry_words, idx_bits: int, starts, counts, *,
                tiles_x: int, tiles_y: int, width: int, height: int,
                tile_w: int = 16, tile_h: int = 16,
                depth_mode: str = "weighted", n_eyes: int = 1,
                r2_cutoff: float = 0.0, pixel_coords=None,
                tile_row_offset: int = 0):
    """Blend + assemble: the CUDA kernel for CUDA tensors, the plain version
    (then :func:`assemble_image`, the eyes concatenated along the width) for
    CPU tensors."""
    if sorted_key.is_cuda:
        return blend_image_cuda(sorted_key, entry_words, idx_bits, starts,
                                counts, tiles_x=tiles_x, tiles_y=tiles_y,
                                width=width, height=height, tile_w=tile_w,
                                tile_h=tile_h, depth_mode=depth_mode,
                                n_eyes=n_eyes, r2_cutoff=r2_cutoff,
                                pixel_coords=pixel_coords,
                                tile_row_offset=tile_row_offset)
    out = blend_tiles_plain(sorted_key, entry_words, idx_bits, starts, counts,
                            tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
                            depth_mode=depth_mode, n_eyes=n_eyes,
                            r2_cutoff=r2_cutoff, pixel_coords=pixel_coords,
                            tile_row_offset=tile_row_offset)
    eyes = [assemble_image(tc, td, tiles_x=tiles_x, tiles_y=tiles_y,
                           width=width, height=height, tile_w=tile_w,
                           tile_h=tile_h)
            for tc, td in (out if n_eyes == 2 else [out])]
    if n_eyes == 1:
        return eyes[0]
    color = torch.cat([c for c, _ in eyes], dim=1)
    depth = None if eyes[0][1] is None else torch.cat([d for _, d in eyes], dim=1)
    return color, depth
