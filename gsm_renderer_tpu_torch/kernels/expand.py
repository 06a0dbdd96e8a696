"""Binning prep (exact 8x4 tile masks, counts, global offset scan), the
per-row exact-span decomposition of oversized rects, and instance expansion
into KeyPlan sort keys.

Port of ``gsm_renderer_tpu/kernels/expand.py``: ``binning_prep_pallas``
(``_prep_kernel``, modes "mono", "stereo" and "warped" with ``lod_min``,
option ``count_rows``), ``row_expand_pallas`` (``_row_expand_kernel``),
``expand_slots_pallas`` (``_expand_kernel``, prebuilt table with KeyPlan
keys, exact tests "mono", "stereo" and "warped") and
``warped_bounds_gather_pallas`` (``_bgather_kernel``), and mode "none" of
the expand (``exact_test=False``: the Hardware renderer's full rects) with
its offsets from prep, where the JAX package computes them in XLA
(``pipelines/common.py::binning_inputs`` and the cumsum of
``expand_slots_pallas``).  The kernels are
``csrc/binning.cu``.  Prep, the row expansion and the expand take tiles of
1 to 4096 pixels a side in every mode (:func:`check_tile`; the 8x4 window
keeps its geometry in tiles, only each test's pixel extents change).  The
JAX expand's ``fused_depth16`` key [tile:16 | depth16:16]
needs no key layout of its own here: the KeyPlan with ``depth_span_bits=16``
orders the slots the same way (``pipelines/common.py``).

The band-sharded frame (``parallel/multichip.py``) adds prep mode "band"
(:func:`binning_prep_band`), which replaces the JAX package's XLA band
clamp (``parallel/multichip.py:245-283``, ``binning_inputs`` with its
``mask_override``) and the exclusive scan of ``expand_slots_pallas``, and
the expand's ``tile_row_offset`` (its exact test at the band's global tile
rows, ``_expand_kernel``'s ``rowoff``).  With no KeyPlan (the stable
fallback) the expand writes the plain tile key, the depth word and the
entry index (``_expand_kernel``'s plain ``key = tile``).

Mode "warped" is the foveated stereo frame's: the physical tile grid is
non-uniform in display space, and a tile's display-space pixel rect is read
from the (2, 128) float32 bounds table of
:func:`gsm_renderer_tpu_torch.stereo.foveated_raster_tables` (indices
clamped to 127).  Its tests are the stereo ones (either eye q <= 9) on those
rects; with ``lod_min`` > 0 the prep also drops periphery instances whose
opacity-weighted footprint the local sampling rate cannot resolve.  The
expand re-tests pre-counted (MASKED) entries in this mode.  The rects it
starts from are the display-size projection's re-binned onto the physical
tiles: :func:`foveated_rebin_cuda`, one launch in place of the plain torch
chain (``pipelines/depth_first.py::foveated_packed``).

The JAX package packs its tables as (planes, rows, 128) for the TPU; here
every table is a flat array: ``offsets`` (N + 1,) with ``offsets[N]`` the slot
total, and ``rect`` / ``mask`` (N,).  The depth and record words are read
straight from the projection outputs (4 words mono; 8 words stereo, the left
record then the right).  Word tensors are int32 holding the u32 bits; the
plain versions widen to int64 for shifts and compares.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _native
from .. import mathlib as M

SENTINEL = 0xFFFFFFFF
#: rect_word bit 30: culled gaussian (its single slot is dead)
CULLED_BIT = 1 << 30
#: rect_word bit 31: exact pre-counted gaussian; its j-th instance is the
#: j-th set bit of its 8x4 tile mask (bit = dy * 8 + dx)
MASKED_BIT = 1 << 31
MASK_W, MASK_H = 8, 4
#: the largest tile side, in pixels, that the kernels and frames take (every
#: side from 1 up): a 4096 x 4096 tile holds 2^24 pixels, so every in-tile
#: pixel offset and every tile bound stays an integer exact in float32 and
#: every pixel index fits int32
MAX_TILE_SIDE = 4096
THETA_UNIT = 3.14159265358979 / 65535.0

#: per-pixel cutoff of the stereo blend (q <= 9); dropping an instance whose
#: minQuadRect over the tile exceeds it leaves the image unchanged
STEREO_R2_CUTOFF = 9.0
#: record words carried per mode ("none" carries the mono record for the
#: blend; its prep and expand read none of it)
MODE_WORDS = {"mono": 4, "stereo": 8, "warped": 8, "none": 4}
#: the kernels' mode codes (``enum Mode`` of csrc/binning.cu)
MODE_CODES = {"mono": 0, "stereo": 1, "warped": 2, "none": 3}
#: entries per axis row of the foveated bounds table
BOUNDS_LANES = 128

PREP = _native.Kernel("prep", "binning", "gsm_prep", [
    _native.P, _native.P, _native.P, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.F, _native.F, _native.F,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P, _native.F])
ROW_EXPAND = _native.Kernel("row_expand", "binning", "gsm_row_expand", [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.F, _native.F, _native.F,
    _native.P, _native.P, _native.P, _native.P, _native.P])
EXPAND = _native.Kernel("expand", "binning", "gsm_expand", [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.F, _native.F,
    _native.F, _native.P, _native.P])
PREP_BAND = _native.Kernel("prep_band", "binning", "gsm_prep_band", [
    _native.P, _native.P, _native.P, _native.P, _native.I, _native.I,
    _native.I, _native.U, _native.U, _native.P, _native.P, _native.P,
    _native.P, _native.P, _native.P, _native.P])
BOUNDS_GATHER = _native.Kernel("bounds_gather", "binning", "gsm_bounds_gather", [
    _native.P, _native.P, _native.P, _native.I, _native.P])
REBIN = _native.Kernel("rebin", "binning", "gsm_foveated_rebin", [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.P, _native.I, _native.I, _native.F, _native.F, _native.P,
    _native.P, _native.P])


#: the fewest elements a block of the prep and row-expand kernels scans
SCAN_TILE = 256
#: (device, stream) -> (ticket, status) of the one-pass scan
_scan_scratch_cache: dict = {}


def scan_scratch(device, elements: int):
    """The look-back scratch of the prep and row-expand kernels' one-pass
    scan on ``device`` and its current stream: ``ticket`` (4,) (the ticket
    word, then prep's three accumulators of the header's sums) and
    ``status`` (>= one word a tile of SCAN_TILE elements) int64, zeroed when
    made and kept.  The kernels leave them valid for the next launch on the
    stream (the epoch scheme of ``csrc/binning.cu``; the last block to add
    to an accumulator zeroes it), so a call zeroes nothing; a larger launch
    gets a new, larger pair."""
    device = torch.device(device)
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else 0)
    tiles = max(-(-elements // SCAN_TILE), 1)
    pair = _scan_scratch_cache.get((device, stream))
    if pair is None or pair[1].numel() < tiles:
        pair = (torch.zeros(4, dtype=torch.int64, device=device),
                torch.zeros(1 << (tiles - 1).bit_length(), dtype=torch.int64,
                            device=device))
        _scan_scratch_cache[(device, stream)] = pair
    return pair


def _popcount(v):
    """SWAR popcount of int64 tensors holding u32 values."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _nth_set_bit(mask, jj):
    """Bit index of the (jj+1)-th set bit of ``mask`` (valid for jj <
    popcount): binary ascent on the prefix popcount."""
    p = torch.zeros_like(jj)
    for step in (16, 8, 4, 2, 1):
        cand = p + step
        low = (torch.ones_like(cand) << cand) - 1
        p = torch.where(_popcount(mask & low) <= jj, cand, p)
    return p


def _f16_bits_to_f32(bits):
    """IEEE f16 bits (low 16 of an int64 tensor) -> float32, subnormals
    flushed to zero."""
    b = bits & 0xFFFF
    sign = (b >> 15) << 31
    exp = (b >> 10) & 0x1F
    mant = b & 0x3FF
    val = M.to_i32(sign | ((exp + 112) << 23) | (mant << 13)).view(torch.float32)
    return torch.where(exp == 0, 0.0, val)


def _u8f(w, shift):
    """float(u8 field) / 255 of an int64 word tensor."""
    return ((w >> shift) & 0xFF).to(torch.int32).to(torch.float32) * (1.0 / 255.0)


def _conic_from_words(w0, w1, w2):
    """Decoded conic (ca, cb, cc), mean and reciprocals of a quantized
    record (int64 word tensors)."""
    mx = _f16_bits_to_f32(w0)
    my = _f16_bits_to_f32(w0 >> 16)
    theta = (w1 & 0xFFFF).to(torch.int32).to(torch.float32) * THETA_UNIT
    s1 = torch.clamp(_f16_bits_to_f32(w1 >> 16), min=1e-4)
    s2 = torch.clamp(_f16_bits_to_f32(w2), min=1e-4)
    c = torch.cos(theta)
    s = torch.sin(theta)
    iv1 = 1.0 / (s1 * s1)
    iv2 = 1.0 / (s2 * s2)
    ca = c * c * iv1 + s * s * iv2
    cb = c * s * (iv1 - iv2)
    cc = s * s * iv1 + c * c * iv2
    return dict(mx=mx, my=my, ca=ca, cb=cb, cc=cc,
                inv_a=1.0 / torch.clamp(ca, min=1e-20),
                inv_c=1.0 / torch.clamp(cc, min=1e-20))


def _d2min_rect(con, xmin, xmax, ymin, ymax):
    """minQuadRect of a decoded conic over a mean-centred rect."""
    ca, cb, cc = con["ca"], con["cb"], con["cc"]
    inside = (xmin <= 0.0) & (0.0 <= xmax) & (ymin <= 0.0) & (0.0 <= ymax)

    def quad(x, y):
        return ca * x * x + 2.0 * cb * x * y + cc * y * y

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    q1 = quad(xmin, clip(-(cb * con["inv_c"]) * xmin, ymin, ymax))
    q2 = quad(xmax, clip(-(cb * con["inv_c"]) * xmax, ymin, ymax))
    q3 = quad(clip(-(cb * con["inv_a"]) * ymin, xmin, xmax), ymin)
    q4 = quad(clip(-(cb * con["inv_a"]) * ymax, xmin, xmax), ymax)
    return torch.where(inside, 0.0, torch.minimum(torch.minimum(q1, q2),
                                                  torch.minimum(q3, q4)))


def _d2_cutoff(w3, alpha_threshold):
    tau = max(alpha_threshold, 1e-12)
    return M.compute_d2_cutoff(_u8f(w3, 24), tau)


def exact_tile_masks(w0, w1, w2, w3, min_tx, min_ty, rect_w, rect_h,
                     tile_w: int, tile_h: int, alpha_threshold: float):
    """Exact per-tile pass mask (bit = dy * 8 + dx) over the 8x4 window at
    the rect's corner, from the quantized record (int64 word tensors).
    Returns (mask int64, count int64)."""
    con = _conic_from_words(w0, w1, w2)
    cutoff = _d2_cutoff(w3, alpha_threshold)
    x_base = min_tx.to(torch.float32) * tile_w - con["mx"]
    y_base = min_ty.to(torch.float32) * tile_h - con["my"]
    mask = torch.zeros_like(w0)
    for p in range(MASK_W * MASK_H):
        dx, dy = p % MASK_W, p // MASK_W
        xmin = x_base + float(dx * tile_w)
        ymin = y_base + float(dy * tile_h)
        d2min = _d2min_rect(con, xmin, xmin + tile_w, ymin, ymin + tile_h)
        passes = (dx < rect_w) & (dy < rect_h) & (d2min <= cutoff)
        mask = mask | (passes.to(torch.int64) << p)
    return mask, _popcount(mask)


def stereo_tile_masks(wl, wr, min_tx, min_ty, rect_w, rect_h, tile_w: int,
                      tile_h: int):
    """Dual-eye exact pass mask over the union tile rect: a position passes
    if EITHER eye's quantized ellipse reaches q <= STEREO_R2_CUTOFF inside
    the tile.  ``wl`` / ``wr``: the (w0, w1, w2) int64 word triples of the
    left / right records.  Returns (mask int64, count int64)."""
    con_l = _conic_from_words(*wl)
    con_r = _conic_from_words(*wr)
    xl = min_tx.to(torch.float32) * tile_w - con_l["mx"]
    yl = min_ty.to(torch.float32) * tile_h - con_l["my"]
    xr = min_tx.to(torch.float32) * tile_w - con_r["mx"]
    yr = min_ty.to(torch.float32) * tile_h - con_r["my"]
    mask = torch.zeros_like(min_tx)
    for p in range(MASK_W * MASK_H):
        dx, dy = p % MASK_W, p // MASK_W
        ox, oy = float(dx * tile_w), float(dy * tile_h)
        d2l = _d2min_rect(con_l, xl + ox, xl + ox + tile_w, yl + oy,
                          yl + oy + tile_h)
        d2r = _d2min_rect(con_r, xr + ox, xr + ox + tile_w, yr + oy,
                          yr + oy + tile_h)
        passes = ((dx < rect_w) & (dy < rect_h)
                  & (torch.minimum(d2l, d2r) <= STEREO_R2_CUTOFF))
        mask = mask | (passes.to(torch.int64) << p)
    return mask, _popcount(mask)


def _exact_tile_test(w0, w1, w2, w3, tx, ty, tile_w, tile_h, alpha_threshold):
    """True where the instance's peak alpha within tile (tx, ty) reaches
    the threshold (minQuadRect <= d2 cutoff)."""
    x0 = tx.to(torch.float32) * tile_w
    y0 = ty.to(torch.float32) * tile_h
    con = _conic_from_words(w0, w1, w2)
    d2min = _d2min_rect(con, x0 - con["mx"], (x0 + tile_w) - con["mx"],
                        y0 - con["my"], (y0 + tile_h) - con["my"])
    return d2min <= _d2_cutoff(w3, alpha_threshold)


def _record_d2min(w0, w1, w2, x0, x1, y0, y1):
    """minQuadRect of a quantized record over the pixel rect [x0, x1] x
    [y0, y1]."""
    con = _conic_from_words(w0, w1, w2)
    return _d2min_rect(con, x0 - con["mx"], x1 - con["mx"], y0 - con["my"],
                       y1 - con["my"])


def _stereo_rect_test(w, x0, x1, y0, y1):
    """Dual-eye test of the stereo expand: either eye's record (words 0..2
    left, 4..6 right) reaches q <= STEREO_R2_CUTOFF inside the pixel rect
    [x0, x1] x [y0, y1]."""
    d2l = _record_d2min(w[0], w[1], w[2], x0, x1, y0, y1)
    d2r = _record_d2min(w[4], w[5], w[6], x0, x1, y0, y1)
    return torch.minimum(d2l, d2r) <= STEREO_R2_CUTOFF


def _bound_index(t, d: int = 0):
    """Index t + d into a bounds row, clamped to the row."""
    return torch.clamp(t.to(torch.int64) + d, 0, BOUNDS_LANES - 1)


# ---------------------------------------------------------------------------
# Kernel 7: the foveated window's display-space boundaries
# ---------------------------------------------------------------------------

def warped_bounds_gather_plain(bounds, min_tx, min_ty):
    """Plain version of the bounds gather: for each gaussian the display
    coordinates of the physical tile boundaries min_t + d of its 8x4 window,
    ``bounds[axis][min(min_t + d, 127)]``.  ``bounds``: the (2, 128) float32
    table; ``min_tx`` / ``min_ty``: (N,) integer tensors >= 0.  Returns (fx,
    a list of MASK_W + 1 (N,) float32 tensors, fy, a list of MASK_H + 1)."""
    fx = [bounds[0][_bound_index(min_tx, d)] for d in range(MASK_W + 1)]
    fy = [bounds[1][_bound_index(min_ty, d)] for d in range(MASK_H + 1)]
    return fx, fy


def warped_bounds_gather_cuda(bounds, min_tx, min_ty):
    """Launch ``gsm_bounds_gather`` of ``csrc/binning.cu`` (one thread per
    gaussian, the table staged in shared memory).  The warped prep runs the
    same gather inside its own kernel; this launch serves the callers that
    need the boundaries themselves."""
    dev = min_tx.device
    n = min_tx.shape[0]
    _native.check(bounds, "bounds", torch.float32, (2, BOUNDS_LANES), dev)
    _native.check(min_tx, "min_tx", torch.int32, (n,), dev)
    _native.check(min_ty, "min_ty", torch.int32, (n,), dev)
    out = torch.empty((MASK_W + MASK_H + 2, n), dtype=torch.float32, device=dev)
    BOUNDS_GATHER.launch(_native.ptr(bounds), _native.ptr(min_tx),
                         _native.ptr(min_ty), n, _native.ptr(out))
    return list(out[:MASK_W + 1]), list(out[MASK_W + 1:])


def warped_bounds_gather(bounds, min_tx, min_ty):
    """Bounds gather: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if min_tx.is_cuda:
        return warped_bounds_gather_cuda(bounds, min_tx, min_ty)
    return warped_bounds_gather_plain(bounds, min_tx, min_ty)


def foveated_rebin_cuda(px_min, px_max, py_min, py_max, seen, inv_fit, *,
                        tiles_x: int, tiles_y: int, tile_w: int = 16,
                        tile_h: int = 16):
    """Launch ``gsm_foveated_rebin`` of ``csrc/binning.cu``: the re-bin of a
    display-size dual-eye projection (its (N,) float32 union pixel bounds
    and bool visibility ``seen``) onto the ``tiles_x`` x ``tiles_y``
    physical tiles of a foveated target through its (2, 13) inverse-warp
    fit ``inv_fit`` (host, passed by value).  One thread a gaussian, the
    plain version's float32 chain operation for operation
    (``pipelines/depth_first.py::foveated_packed``, which the tests hold it
    to bit for bit).  Returns the physical (rect word, rect_h) int32 and
    the re-binned visibility."""
    check_tile(tile_w, tile_h, "re-bin kernel")
    dev = seen.device
    n = seen.shape[0]
    for name, t in (("px_min", px_min), ("px_max", px_max),
                    ("py_min", py_min), ("py_max", py_max)):
        _native.check(t, name, torch.float32, (n,), dev)
    _native.check(seen, "seen", torch.bool, (n,), dev)
    fit = np.ascontiguousarray(inv_fit, np.float32)
    if fit.shape != (2, 13):
        raise ValueError(f"inv_fit: shape {fit.shape}, expected (2, 13)")
    rects = torch.empty((2, n), dtype=torch.int32, device=dev)
    visible = torch.empty(n, dtype=torch.bool, device=dev)
    REBIN.launch(_native.ptr(px_min), _native.ptr(px_max), _native.ptr(py_min),
                 _native.ptr(py_max), _native.ptr(seen), n,
                 fit.ctypes.data_as(ctypes.c_void_p), tiles_x, tiles_y,
                 float(np.float32(1.0 / tile_w)),
                 float(np.float32(1.0 / tile_h)), _native.ptr(rects[0]),
                 _native.ptr(rects[1]), _native.ptr(visible))
    return rects[0], rects[1], visible


def stereo_warped_tile_masks(wl, wr, rect_w, rect_h, fx, fy, *, w3=None,
                             lod_min: float = 0.0, tile_w: int = 16,
                             tile_h: int = 16):
    """Dual-eye exact pass mask of the foveated frame: position (dx, dy) of
    the 8x4 window is tested against the physical tile's display-space
    pixel rect [fx[dx], fx[dx + 1]] x [fy[dy], fy[dy + 1]].

    With ``lod_min`` > 0 (periphery LOD; needs ``w3``, the eye-shared
    colour/opacity word) a position is also dropped where op * max(sigma1 *
    sigma2 over the eyes) * ar < lod_min * (1 - min(ar, 1)), ar =
    (tile_w / rect width) * (tile_h / rect height) the local rate product:
    in the fovea ar = 1 and the threshold vanishes.  ``wl`` / ``wr``: the
    (w0, w1, w2) int64 word triples of the eyes; ``fx`` / ``fy``: from
    :func:`warped_bounds_gather`.  Returns (mask int64, count int64)."""
    con_l = _conic_from_words(*wl)
    con_r = _conic_from_words(*wr)
    if lod_min > 0.0:
        if w3 is None:
            raise ValueError("lod_min > 0 needs the opacity word w3")

        def sig(w, shift):
            return torch.clamp(_f16_bits_to_f32(w >> shift), min=1e-4)

        ink = _u8f(w3, 24) * torch.maximum(sig(wl[1], 16) * sig(wl[2], 0),
                                           sig(wr[1], 16) * sig(wr[2], 0))
    mask = torch.zeros_like(rect_w)
    for p in range(MASK_W * MASK_H):
        dx, dy = p % MASK_W, p // MASK_W
        x0, x1, y0, y1 = fx[dx], fx[dx + 1], fy[dy], fy[dy + 1]
        d2l = _d2min_rect(con_l, x0 - con_l["mx"], x1 - con_l["mx"],
                          y0 - con_l["my"], y1 - con_l["my"])
        d2r = _d2min_rect(con_r, x0 - con_r["mx"], x1 - con_r["mx"],
                          y0 - con_r["my"], y1 - con_r["my"])
        passes = ((dx < rect_w) & (dy < rect_h)
                  & (torch.minimum(d2l, d2r) <= STEREO_R2_CUTOFF))
        if lod_min > 0.0:
            ar = (M.rdiv(float(tile_w), torch.clamp(x1 - x0, min=1e-6))
                  * M.rdiv(float(tile_h), torch.clamp(y1 - y0, min=1e-6)))
            passes = passes & (ink * ar >= lod_min
                               * (1.0 - torch.clamp(ar, max=1.0)))
        mask = mask | (passes.to(torch.int64) << p)
    return mask, _popcount(mask)


def row_tile_span(w0, w1, w2, w3, ty, min_tx, rect_w, tile_w: float,
                  tile_h: float, alpha_threshold: float):
    """Conservatively widened tile-column span of the quantized record's
    ellipse {q <= d2 cutoff} within tile row ``ty`` (int64 word tensors).

    Along one tile row the tiles passing the exact test are contiguous: a
    tile spans the row's whole pixel band, so it passes iff its x-range
    meets the ellipse's x-extent over the band, which is closed-form.  The
    span is widened by 0.125 + 1e-5 |x| so that float disagreement with the
    exact test can only add boundary tiles, which the expand's exact test
    then removes.  Returns (t_lo, span) int64; span 0 when the ellipse
    misses the row or the opacity is below the threshold."""
    mx = _f16_bits_to_f32(w0)
    my = _f16_bits_to_f32(w0 >> 16)
    theta = (w1 & 0xFFFF).to(torch.int32).to(torch.float32) * THETA_UNIT
    s1 = torch.clamp(_f16_bits_to_f32(w1 >> 16), min=1e-4)
    s2 = torch.clamp(_f16_bits_to_f32(w2), min=1e-4)
    c = torch.cos(theta)
    s = torch.sin(theta)
    iv1 = 1.0 / (s1 * s1)
    iv2 = 1.0 / (s2 * s2)
    ca = c * c * iv1 + s * s * iv2
    cb = c * s * (iv1 - iv2)
    det = iv1 * iv2  # == ca * cc - cb^2, without the cancellation
    k = _d2_cutoff(w3, alpha_threshold)

    y0 = ty.to(torch.float32) * tile_h - my
    y1 = y0 + tile_h
    cak = ca * k
    ylim = torch.sqrt(torch.clamp(cak / det, min=0.0))
    yc0 = torch.maximum(y0, -ylim)
    yc1 = torch.minimum(y1, ylim)
    empty = (k < 0.0) | (yc0 > yc1)

    inv_ca = 1.0 / torch.clamp(ca, min=1e-20)
    t_mag = torch.sqrt(torch.clamp(cak / (det * (det + cb * cb)), min=0.0))

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    yb = clip(-cb * t_mag, yc0, yc1)
    ya = clip(cb * t_mag, yc0, yc1)

    def sq_disc(y):
        return torch.sqrt(torch.clamp(cak - det * y * y, min=0.0))

    xb = (-cb * yb + sq_disc(yb)) * inv_ca
    xa = (-cb * ya - sq_disc(ya)) * inv_ca
    pad = 1e-5 * (xa.abs() + xb.abs()) + 0.125
    xs0 = xa + mx - pad
    xs1 = xb + mx + pad
    inv_tw = 1.0 / tile_w
    t_lo = torch.floor(xs0 * inv_tw).to(torch.int32).to(torch.int64)
    t_hi = torch.floor(xs1 * inv_tw).to(torch.int32).to(torch.int64)
    t_lo = torch.maximum(t_lo, min_tx)
    t_hi = torch.minimum(t_hi, min_tx + rect_w - 1)
    span = torch.where(empty, 0, torch.clamp(t_hi - t_lo + 1, min=0))
    return t_lo, span


def _check_mode(mode: str, words):
    if mode not in MODE_WORDS:
        raise NotImplementedError(f"binning mode {mode!r} is not ported yet")
    if len(words) != MODE_WORDS[mode]:
        raise ValueError(f"mode {mode!r} carries {MODE_WORDS[mode]} record "
                         f"words, got {len(words)}")


def check_tile(tile_w: int, tile_h: int, what: str = "frame") -> None:
    """Raise ValueError unless both tile sides are integers from 1 to
    MAX_TILE_SIDE (the JAX package takes any side unchecked): a side below
    1 tiles nothing, and a longer side would let a tile's pixel offsets
    pass the integers float32 holds exactly."""
    if not all(1 <= s <= MAX_TILE_SIDE for s in (tile_w, tile_h)):
        raise ValueError(
            f"the {what} takes tile sides of 1 to {MAX_TILE_SIDE} pixels, got "
            f"{tile_w}x{tile_h}: a side below 1 tiles nothing, and a longer "
            "side would let a tile hold more than 2^24 pixels, past the "
            "integers float32 holds exactly")


# ---------------------------------------------------------------------------
# Kernel 2: binning prep
# ---------------------------------------------------------------------------

def _check_warped(mode: str, warped_bounds):
    if (mode == "warped") != (warped_bounds is not None):
        raise ValueError("mode 'warped' and warped_bounds go together")


def visible_rect_total(rect_word, rect_h, visible):
    """The rect total of the ``visible`` gaussians, sum of rect_w * rect_h
    (int32, modulo 2^32): the header's ``total_instances`` where the JAX
    frame reports its XLA binning's ``total_live`` (stereo, foveated,
    ``max_per_tile``)."""
    rect_w = (M.u32(rect_word) >> 20) & 0x3FF
    return torch.where(visible, rect_w * rect_h, 0).sum().to(torch.int32)


def row_demand(rect_word, rect_h):
    """Virtual-row demand of the per-row decomposition (one row per
    mask-eligible or culled gaussian, ``rect_h`` per oversized rect;
    int32, modulo 2^32); the header reports it every frame, as the JAX
    package does."""
    rw = M.u32(rect_word)
    visible = (rw & CULLED_BIT) == 0
    rect_w = (rw >> 20) & 0x3FF
    oversized = visible & ((rect_w > MASK_W) | (rect_h > MASK_H))
    return torch.where(oversized, rect_h, 1).sum().to(torch.int32)


#: the fields of prep's header sums record, in order
HEADER_SUMS = ("visible", "rect_total", "row_demand")


def header_sums_plain(rect_word, rect_h, row_total=None):
    """Plain version of the header sums that the prep kernel writes: (3,)
    int32, the visible count (the rect word's CULLED bit clear), the
    :func:`visible_rect_total` and the :func:`row_demand` -- the torch sums
    the frames' headers took before prep wrote them -- or, given, the
    ``row_total`` (a 0-d int32: under ``count_rows`` the scan's total,
    which the kernel reports)."""
    visible = (M.u32(rect_word) & CULLED_BIT) == 0
    rows = row_demand(rect_word, rect_h) if row_total is None else row_total
    return torch.stack([visible.sum().to(torch.int32),
                        visible_rect_total(rect_word, rect_h, visible), rows])


def binning_prep_plain(rect_word, rect_h, words, *, mode: str = "mono",
                       count_rows: bool = False, tile_w: int = 16,
                       tile_h: int = 16, alpha_threshold: float = 0.005,
                       warped_bounds=None, lod_min: float = 0.0):
    """Plain version of the prep kernel.  ``mode`` "mono" (4 words, the
    alpha-cutoff exact masks), "stereo" (8 words, the dual-eye q <= 9
    masks), "warped" (8 words, the dual-eye masks on the display-space
    rects of the (2, 128) ``warped_bounds`` table, with the periphery LOD
    drop when ``lod_min`` > 0) or "none" (no test: the whole rect of a
    visible gaussian, one dead slot for a culled one).  With ``count_rows``
    the counts are virtual tile rows (one per mask-eligible or culled
    gaussian, ``rect_h`` per oversized rect) for :func:`row_expand`.
    Returns (offsets (N+1,) int32 with offsets[N] the total, rect' (N,)
    int32 with MASKED/CULLED bits, mask (N,) int32, the header sums (3,)
    int32 of :func:`header_sums_plain`, whose row demand under
    ``count_rows`` is offsets[N]); in mode "none" rect' is ``rect_word``
    itself and the mask None."""
    _check_mode(mode, words)
    _check_warped(mode, warped_bounds)
    _check_count_rows(mode, count_rows)
    rw = M.u32(rect_word)
    min_tx = rw & 0x3FF
    min_ty = (rw >> 10) & 0x3FF
    rect_w = (rw >> 20) & 0x3FF
    culled0 = (rw & CULLED_BIT) != 0
    rh = rect_h.to(torch.int64)
    if mode == "none":
        counts = torch.clamp(torch.where(culled0, 0, rect_w * rh), min=1)
        return (_exclusive_offsets(counts), rect_word, None,
                header_sums_plain(rect_word, rect_h))
    w = [M.u32(x) for x in words]
    if mode == "warped":
        fx, fy = warped_bounds_gather_plain(warped_bounds, min_tx, min_ty)
        mask, cnt = stereo_warped_tile_masks(w[0:3], w[4:7], rect_w, rh, fx,
                                             fy, w3=w[3], lod_min=lod_min,
                                             tile_w=tile_w, tile_h=tile_h)
    elif mode == "stereo":
        mask, cnt = stereo_tile_masks(w[0:3], w[4:7], min_tx, min_ty, rect_w,
                                      rh, tile_w, tile_h)
    else:
        mask, cnt = exact_tile_masks(w[0], w[1], w[2], w[3], min_tx, min_ty,
                                     rect_w, rh, tile_w, tile_h,
                                     alpha_threshold)
    visible = ~culled0
    eligible = visible & (rect_w <= MASK_W) & (rh <= MASK_H)
    if count_rows:
        counts = torch.where(visible & ~eligible, rh, 1)
    else:
        counts = torch.where(visible, torch.where(eligible, cnt, rect_w * rh), 0)
    culled = culled0 | (eligible & (cnt == 0))
    rect_out = (rw | torch.where(eligible, MASKED_BIT, 0)
                | torch.where(culled, CULLED_BIT, 0))
    # every gaussian owns >= 1 slot: offsets strictly increase
    offsets = _exclusive_offsets(torch.clamp(counts, min=1))
    sums = header_sums_plain(rect_word, rect_h,
                             offsets[-1] if count_rows else None)
    return offsets, M.to_i32(rect_out), M.to_i32(mask), sums


def _exclusive_offsets(counts):
    """(N + 1,) int32 exclusive scan of int64 counts, the total last."""
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                          device=counts.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets.to(torch.int32)


def _check_count_rows(mode: str, count_rows: bool):
    if count_rows and mode != "mono":
        raise ValueError("count_rows is a mono prep option")


def binning_prep_cuda(rect_word, rect_h, words, *, mode: str = "mono",
                      count_rows: bool = False, tile_w: int = 16,
                      tile_h: int = 16, alpha_threshold: float = 0.005,
                      warped_bounds=None, lod_min: float = 0.0):
    """Launch the prep kernel of ``csrc/binning.cu``: one launch, a block
    of 256 gaussians each decoded once, their window tests balanced across
    each warp, and the global offset scan in the same pass (decoupled
    look-back over :func:`scan_scratch`), and the header sums beside it
    (each block's partials added to the scratch's accumulators, the last
    block to arrive writing the total; the row demand under
    ``count_rows``, the scan's total).  In mode "warped" the tests read
    the window's boundaries from the bounds table staged in shared
    memory.  In mode "none" it reads the rect word and rect_h alone and
    writes the offsets and sums alone: it returns ``rect_word`` as rect'
    and no mask, as the plain version does."""
    _check_mode(mode, words)
    check_tile(tile_w, tile_h, "prep kernel")
    _check_warped(mode, warped_bounds)
    _check_count_rows(mode, count_rows)
    dev = rect_word.device
    n = rect_word.shape[0]
    for name, t in (("rect_word", rect_word), ("rect_h", rect_h),
                    *((f"w{k}", w) for k, w in enumerate(words))):
        _native.check(t, name, torch.int32, (n,), dev)
    if warped_bounds is not None:
        _native.check(warped_bounds, "warped_bounds", torch.float32,
                      (2, BOUNDS_LANES), dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    sums = torch.empty(len(HEADER_SUMS), dtype=torch.int32, device=dev)
    rect_out = mask = None
    if mode != "none":
        rect_out = torch.empty(n, dtype=torch.int32, device=dev)
        mask = torch.empty(n, dtype=torch.int32, device=dev)
    ticket, status = scan_scratch(dev, n)
    PREP.launch(_native.ptr(rect_word), _native.ptr(rect_h), _native.ptr_array(words),
                len(words), MODE_CODES[mode], int(count_rows), n, tile_w,
                tile_h, M.f32(max(alpha_threshold, 1e-12)), M.f32(THETA_UNIT),
                M.f32(1.0 / 255.0), _native.ptr(offsets), _native.ptr_or_null(rect_out),
                _native.ptr_or_null(mask), _native.ptr(sums), _native.ptr(ticket),
                _native.ptr(status), _native.ptr_or_null(warped_bounds),
                M.f32(lod_min))
    return offsets, rect_word if mode == "none" else rect_out, mask, sums


def binning_prep(rect_word, rect_h, words, **kw):
    """Prep of the packed projection: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if rect_word.is_cuda:
        return binning_prep_cuda(rect_word, rect_h, words, **kw)
    return binning_prep_plain(rect_word, rect_h, words, **kw)


# ---------------------------------------------------------------------------
# Kernel 2, mode "band": the band clamp of a band-sharded frame
# ---------------------------------------------------------------------------

def _band_normalization(key_plan):
    """(near_key, span) of the depth-word normalization: the KeyPlan's, or
    the identity for the plain tile key."""
    return (0, SENTINEL) if key_plan is None else (key_plan.near_key,
                                                   key_plan.span)


def _check_band(band0: int, band1: int):
    if not 0 <= band0 < band1:
        raise ValueError(f"a band is tile rows [band0, band1) with 0 <= band0 "
                         f"< band1, got [{band0}, {band1})")


def binning_prep_band_plain(rect_word, rect_rows, dkey, mask, *, band0: int,
                            band1: int, key_plan=None):
    """Plain version of prep mode "band" (the JAX package's XLA band clamp,
    ``parallel/multichip.py:245-283``, and ``binning_inputs`` with its
    ``mask_override``).  Inputs are the gathered planes of every gaussian of
    the frame (int32 holding u32 bits): ``rect_word`` (min_tx | . | rect_w
    << 20; bits 10-19 and 30-31 unread), ``rect_rows`` (min_ty | max_ty <<
    10), ``dkey`` (the raw sortable depth key, 0xFFFFFFFF where culled) and
    ``mask`` (the 8x4 exact-test mask at the rect's corner).  Each rect is
    clamped to the tile rows [band0, band1); a gaussian whose rect fits the
    window counts its band sub-mask (the mask's rows from the clamp on), any
    other visible one its rect_w x rows-in-band, and one culled or outside
    the band one dead slot.  The depth word is normalized under
    ``key_plan`` (unchanged without one, the stable fallback's key).
    Returns (offsets (N+1,), the band-local rect' (min_tx | (bty0 - band0)
    << 10 | rect_w << 20, MASKED / CULLED), the sub-mask, the depth word,
    the header sums (3,) of the band clamp: :func:`header_sums_plain` of
    the rect_w x rows-in-band rects, visible where the gaussian is visible
    and in the band), int32."""
    _check_band(band0, band1)
    rw, rows, dk = M.u32(rect_word), M.u32(rect_rows), M.u32(dkey)
    min_tx = rw & 0x3FF
    rect_w = (rw >> 20) & 0x3FF
    min_ty = rows & 0x3FF
    max_ty = (rows >> 10) & 0x3FF
    bty0 = torch.clamp(min_ty, min=band0)
    bty1 = torch.clamp(max_ty, max=band1 - 1)
    rows_in_band = torch.clamp(bty1 - bty0 + 1, min=0)
    visible_here = (dk != SENTINEL) & (rows_in_band > 0)
    shift = torch.clamp(bty0 - min_ty, 0, MASK_H - 1)
    rows_bits = torch.where(
        rows_in_band >= MASK_H, SENTINEL,
        (1 << (8 * torch.clamp(rows_in_band, 0, MASK_H - 1))) - 1)
    sub = (M.u32(mask) >> (8 * shift)) & rows_bits
    sub_cnt = _popcount(sub)
    eligible = (visible_here & (rect_w <= MASK_W)
                & (max_ty - min_ty + 1 <= MASK_H))
    visible = visible_here & (~eligible | (sub_cnt > 0))
    counts = torch.where(eligible, sub_cnt,
                         torch.where(visible_here, rect_w * rows_in_band, 0))
    rect_out = (min_tx | ((bty0 - band0) << 10) | (rect_w << 20)
                | torch.where(eligible, MASKED_BIT, 0)
                | torch.where(visible, 0, CULLED_BIT))
    near_key, span = _band_normalization(key_plan)
    dsw = torch.clamp(torch.clamp(dk, min=near_key) - near_key, max=span)
    band_rect = (rect_w << 20) | torch.where(visible_here, 0, CULLED_BIT)
    sums = header_sums_plain(M.to_i32(band_rect),
                             rows_in_band.to(torch.int32))
    return (_exclusive_offsets(torch.clamp(counts, min=1)), M.to_i32(rect_out),
            M.to_i32(sub), M.to_i32(dsw), sums)


def binning_prep_band_cuda(rect_word, rect_rows, dkey, mask, *, band0: int,
                           band1: int, key_plan=None):
    """Launch ``gsm_prep_band`` of ``csrc/binning.cu``: one launch, a
    gaussian a thread, 256 a block, with the one-pass look-back scan of the
    other prep modes (:func:`scan_scratch`)."""
    _check_band(band0, band1)
    dev = rect_word.device
    n = rect_word.shape[0]
    for name, t in (("rect_word", rect_word), ("rect_rows", rect_rows),
                    ("dkey", dkey), ("mask", mask)):
        _native.check(t, name, torch.int32, (n,), dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    sums = torch.empty(len(HEADER_SUMS), dtype=torch.int32, device=dev)
    ticket, status = scan_scratch(dev, n)
    near_key, span = _band_normalization(key_plan)
    PREP_BAND.launch(_native.ptr(rect_word), _native.ptr(rect_rows),
                     _native.ptr(dkey), _native.ptr(mask), n, band0, band1,
                     near_key, span, _native.ptr(offsets), _native.ptr(out[0]),
                     _native.ptr(out[1]), _native.ptr(out[2]),
                     _native.ptr(sums), _native.ptr(ticket),
                     _native.ptr(status))
    return offsets, out[0], out[1], out[2], sums


def binning_prep_band(rect_word, rect_rows, dkey, mask, **kw):
    """Prep mode "band": the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if rect_word.is_cuda:
        return binning_prep_band_cuda(rect_word, rect_rows, dkey, mask, **kw)
    return binning_prep_band_plain(rect_word, rect_rows, dkey, mask, **kw)


# ---------------------------------------------------------------------------
# Row expansion: virtual tile rows narrowed to their exact column spans
# ---------------------------------------------------------------------------

def row_expand_plain(offsets, rect, mask, dsw, words, *, row_capacity: int,
                     tile_w: int = 16, tile_h: int = 16,
                     alpha_threshold: float = 0.005):
    """Plain version of the row-expand kernel.

    Input: a mono prep table built with ``count_rows=True`` (offsets count
    virtual rows).  Row r < R = ``row_capacity`` belongs to the gaussian g
    with offsets[g] <= r < offsets[g + 1], tile row min_ty + (r -
    offsets[g]).  A mask-eligible or culled gaussian's single row passes
    through; an oversized rect's row gets rect' = span_lo | ty << 10 |
    span_w << 20 (CULLED when the span is empty).  Its instance count is 1
    (culled or empty), the mask popcount (masked) or the span width.  Rows
    past the row total or R count 0 and carry zero planes.

    Returns (offsets2 (R+1,), rect2, mask2, dsw2 (R,), words2 (4 x (R,)),
    all int32, and row_overflow = row total > R as a 0-d int32 tensor)."""
    _check_mode("mono", words)
    dev = offsets.device
    n = rect.shape[0]
    off = offsets.to(torch.int64)
    total1 = off[n]
    row = torch.arange(row_capacity, dtype=torch.int64, device=dev)
    g = torch.searchsorted(off[:n].contiguous(), row, right=True) - 1
    g = torch.clamp(g, 0, max(n - 1, 0))
    jj = row - off[g]
    live = row < total1
    rect_u = M.u32(rect)[g]
    mask_u = M.u32(mask)[g]
    w = [M.u32(x)[g] for x in words]
    culled = (rect_u & CULLED_BIT) != 0
    masked = (rect_u & MASKED_BIT) != 0
    min_tx = rect_u & 0x3FF
    min_ty = (rect_u >> 10) & 0x3FF
    rect_w = (rect_u >> 20) & 0x3FF
    ty = min_ty + jj
    t_lo, span = row_tile_span(w[0], w[1], w[2], w[3], ty, min_tx, rect_w,
                               float(tile_w), float(tile_h), alpha_threshold)
    passthrough = masked | culled
    empty = ~passthrough & (span == 0)
    rect2 = torch.where(passthrough, rect_u, t_lo | (ty << 10) | (span << 20))
    rect2 = torch.where(empty, rect2 | CULLED_BIT, rect2)
    cnt = torch.where(culled | empty, 1,
                      torch.where(masked, _popcount(mask_u), span))
    cnt = torch.where(live, cnt, 0)
    offsets2 = torch.zeros(row_capacity + 1, dtype=torch.int64, device=dev)
    offsets2[1:] = torch.cumsum(cnt, 0)

    def plane(x):
        return M.to_i32(torch.where(live, x, 0))

    return (offsets2.to(torch.int32), plane(rect2), plane(mask_u),
            plane(M.u32(dsw)[g]), [plane(x) for x in w],
            (total1 > row_capacity).to(torch.int32))


def row_expand_cuda(offsets, rect, mask, dsw, words, *, row_capacity: int,
                    tile_w: int = 16, tile_h: int = 16,
                    alpha_threshold: float = 0.005):
    """Launch the row-expand kernel of ``csrc/binning.cu``: one launch, a
    block of 2048 rows that finds its first row's gaussian with one k-ary
    search, stages the offsets of the 2048 gaussians from there in shared
    memory and searches them per row, and the offset scan in the same pass
    (decoupled look-back over :func:`scan_scratch`); the kernel also writes
    row_overflow.  Needs every gaussian to own >= 1 row, as prep
    ``count_rows`` makes them (unchecked)."""
    check_tile(tile_w, tile_h, "row-expand kernel")
    _check_mode("mono", words)
    dev = offsets.device
    n = rect.shape[0]
    _native.check(offsets, "offsets", torch.int32, (n + 1,), dev)
    for name, t in (("rect", rect), ("mask", mask), ("dsw", dsw),
                    *((f"w{k}", w) for k, w in enumerate(words))):
        _native.check(t, name, torch.int32, (n,), dev)
    r = row_capacity
    offsets2 = torch.empty(r + 1, dtype=torch.int32, device=dev)
    planes = torch.empty((7, r), dtype=torch.int32, device=dev)
    row_overflow = torch.empty((), dtype=torch.int32, device=dev)
    ticket, status = scan_scratch(dev, r)
    ROW_EXPAND.launch(_native.ptr(offsets), _native.ptr(rect), _native.ptr(mask),
                      _native.ptr(dsw), _native.ptr_array(words), n, r,
                      tile_w, tile_h, M.f32(max(alpha_threshold, 1e-12)),
                      M.f32(THETA_UNIT), M.f32(1.0 / 255.0),
                      _native.ptr(offsets2),
                      _native.ptr(planes), _native.ptr(row_overflow),
                      _native.ptr(ticket), _native.ptr(status))
    return (offsets2, planes[0], planes[1], planes[2], list(planes[3:]),
            row_overflow)


def row_expand(offsets, rect, mask, dsw, words, **kw):
    """Row expansion: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if offsets.is_cuda:
        return row_expand_cuda(offsets, rect, mask, dsw, words, **kw)
    return row_expand_plain(offsets, rect, mask, dsw, words, **kw)


# ---------------------------------------------------------------------------
# Kernel 4: slot expansion with KeyPlan keys
# ---------------------------------------------------------------------------

def expand_slots_plain(offsets, rect, mask, dsw, words, *, capacity: int,
                       tiles_x: int, key_plan, mode: str = "mono",
                       tile_w: int = 16, tile_h: int = 16,
                       alpha_threshold: float = 0.005, warped_bounds=None,
                       tile_row_offset: int = 0):
    """Plain version of the expand kernel.

    Slot s < total belongs to the entry g (a gaussian, or a virtual row of a
    row table) with offsets[g] <= s < offsets[g + 1].  Precondition: every
    entry below the total owns at least one slot -- offsets rise strictly up
    to the total, and only a row table's dead tail repeats it -- as prep and
    the row expansion guarantee (a culled entry keeps one dead slot).  The
    kernel relies on it (:func:`expand_slots_cuda`); this version would
    also take a zero-count entry in the middle, where the kernel would write
    wrong keys.  A live slot never lands on a dead row.  The tile is the j-th set bit of
    the mask (MASKED entries) or a row-major walk of the rect plus the exact
    test: the alpha cutoff (``mode`` "mono"), the dual-eye q <= 9 test
    ("stereo"), the dual-eye test on the display-space rect of the
    physical tile from the (2, 128) ``warped_bounds`` table ("warped"), or
    none ("none": every slot of a visible entry's rect is live; the mask
    may be None).  MASKED entries skip the test, except under the warp.
    ``tile_row_offset`` (mode "mono"): the frame's tile row of the table's
    row 0, a band's first row; the test runs at (t_x, t_y +
    tile_row_offset), the keys keep the table's (band-local) tiles.
    Returns (key1
    (C,), key2 (C,)) int32 with the sentinel in both keys for dead slots,
    then the unclamped slot total and the overflow flag as 0-d int32
    tensors.  No record word is carried per slot: a live slot's entry index
    is the low ``key_plan.idx_bits`` bits of key2, and the blend reads the
    entry's words through it.  With ``key_plan`` None (the stable
    fallback) key1 is the plain tile id, key2 the depth word itself, and a
    third plane, the entry index, follows the keys: (key1, key2, entry,
    total, overflow), the sentinel in all three at dead slots.
    """
    _check_mode(mode, words)
    _check_warped(mode, warped_bounds)
    _check_row_offset(mode, tile_row_offset)
    dev = offsets.device
    n = rect.shape[0]
    off = offsets.to(torch.int64)
    total = off[n]
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    g = torch.searchsorted(off[:n].contiguous(), slot, right=True) - 1
    g = torch.clamp(g, 0, max(n - 1, 0))
    jj = slot - off[g]
    rw = M.u32(rect)[g]
    min_tx = rw & 0x3FF
    min_ty = (rw >> 10) & 0x3FF
    rect_w = torch.clamp((rw >> 20) & 0x3FF, min=1)
    culled = (rw & CULLED_BIT) != 0
    q = torch.div(jj, rect_w, rounding_mode="floor")
    r = jj - q * rect_w
    if mode != "none":
        is_masked = (rw & MASKED_BIT) != 0
        pbit = _nth_set_bit(M.u32(mask)[g], jj)
        q = torch.where(is_masked, pbit >> 3, q)
        r = torch.where(is_masked, pbit & 7, r)
    t_y = min_ty + q
    t_x = min_tx + r
    tile = t_y * tiles_x + t_x
    w = [M.u32(x)[g] for x in words]
    if mode == "none":
        passes = torch.ones_like(culled)
    elif mode == "warped":
        bx, by = warped_bounds[0], warped_bounds[1]
        passes = _stereo_rect_test(w, bx[_bound_index(t_x)],
                                   bx[_bound_index(t_x, 1)],
                                   by[_bound_index(t_y)],
                                   by[_bound_index(t_y, 1)])
    elif mode == "stereo":
        x0 = t_x.to(torch.float32) * float(tile_w)
        y0 = t_y.to(torch.float32) * float(tile_h)
        passes = _stereo_rect_test(w, x0, x0 + float(tile_w), y0,
                                   y0 + float(tile_h))
    else:
        passes = _exact_tile_test(w[0], w[1], w[2], w[3], t_x,
                                  t_y + tile_row_offset, float(tile_w),
                                  float(tile_h), alpha_threshold)
    if mode in ("mono", "stereo"):
        # a pre-counted entry passed this very test at prep; under the warp
        # the JAX expand re-tests it, so the port does too
        passes = passes | is_masked
    dead = (slot >= total) | culled | ~passes
    dn = M.u32(dsw)[g]
    if key_plan is None:
        keys = (tile, dn, g)
    else:
        d_hi, d_lo, idx_bits = key_plan.kernel_tuple
        keys = (((tile << d_hi) | (dn >> d_lo)) & M.U32,
                (((dn & ((1 << d_lo) - 1)) << idx_bits) | g) & M.U32)
    return (*(M.to_i32(torch.where(dead, SENTINEL, k)) for k in keys),
            total.to(torch.int32), (total > capacity).to(torch.int32))


def _check_row_offset(mode: str, tile_row_offset: int):
    if tile_row_offset < 0 or (tile_row_offset and mode != "mono"):
        raise ValueError(f"a tile row offset >= 0 is a mono expand option, "
                         f"got {tile_row_offset} in mode {mode!r}")


def expand_slots_cuda(offsets, rect, mask, dsw, words, *, capacity: int,
                      tiles_x: int, key_plan, mode: str = "mono",
                      tile_w: int = 16, tile_h: int = 16,
                      alpha_threshold: float = 0.005, warped_bounds=None,
                      tile_row_offset: int = 0):
    """Launch the expand kernel of ``csrc/binning.cu`` (1024 slots a CTA:
    one k-ary search over the offsets, the CTA's entries staged in shared
    memory and searched there; in mode "warped" the bounds table staged in
    shared memory too).  Writes the two key planes only, or with no
    ``key_plan`` the plain tile key, the depth word and the entry index.

    Precondition (unchecked, as for :func:`expand_slots_plain`): every entry
    below the total owns at least one slot, so that the 1025 entries from a
    CTA's first one cover all its 1024 slots; a table with a zero-count
    entry before the total gets wrong keys.  Prep and the row expansion
    make tables that meet it; a row table's dead tail past the total is
    allowed.  In mode "none" the mask may be None: the kernel reads no mask
    and no record word there."""
    _check_mode(mode, words)
    check_tile(tile_w, tile_h, "expand kernel")
    _check_warped(mode, warped_bounds)
    _check_row_offset(mode, tile_row_offset)
    dev = offsets.device
    n = rect.shape[0]
    _native.check(offsets, "offsets", torch.int32, (n + 1,), dev)
    if mask is None and mode != "none":
        raise ValueError(f"mode {mode!r} reads the prep mask")
    for name, t in (("rect", rect), ("mask", mask), ("dsw", dsw),
                    *((f"w{k}", w) for k, w in enumerate(words))):
        if t is not None:
            _native.check(t, name, torch.int32, (n,), dev)
    if warped_bounds is not None:
        _native.check(warped_bounds, "warped_bounds", torch.float32,
                      (2, BOUNDS_LANES), dev)
    plain_key = key_plan is None
    d_hi, d_lo, idx_bits = (0, 0, 32) if plain_key else key_plan.kernel_tuple
    out = torch.empty((3 if plain_key else 2, capacity), dtype=torch.int32,
                      device=dev)
    EXPAND.launch(_native.ptr(offsets), _native.ptr(rect), _native.ptr_or_null(mask),
                  _native.ptr(dsw), _native.ptr_array(words), len(words),
                  MODE_CODES[mode], n, capacity, tiles_x, tile_w, tile_h,
                  d_hi, d_lo, idx_bits, tile_row_offset, int(plain_key),
                  M.f32(max(alpha_threshold, 1e-12)), M.f32(THETA_UNIT),
                  M.f32(1.0 / 255.0), _native.ptr(out),
                  _native.ptr_or_null(warped_bounds))
    # a copy, not a view: a header that keeps its slot total (the capacity
    # feedback, a recorded frame) keeps 4 bytes, not the offsets; the
    # compare writes the int32 flag itself, so the copy adds no launch
    total = offsets[n].clone()
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    return (*out, total, torch.gt(total, capacity, out=overflow))


def expand_slots(offsets, rect, mask, dsw, words, **kw):
    """Slot expansion: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if offsets.is_cuda:
        return expand_slots_cuda(offsets, rect, mask, dsw, words, **kw)
    return expand_slots_plain(offsets, rect, mask, dsw, words, **kw)
