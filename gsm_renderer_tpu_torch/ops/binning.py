"""Sort-key planning, rect packing and tile-range extraction.

PyTorch counterpart of ``gsm_renderer_tpu/ops/binning.py``.  Word tensors are
int32 holding the u32 bits; arithmetic that needs the unsigned value widens
to int64 (``mathlib.u32``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mathlib import U32, to_i32

SENTINEL_KEY = 0xFFFFFFFF


def _sortable_u32(x: float) -> int:
    bits = int(np.float32(x).view(np.uint32))
    return bits ^ (0xFFFFFFFF if bits & 0x80000000 else 0x80000000)


@dataclasses.dataclass(frozen=True)
class KeyPlan:
    """Tie-free split of the (tile, depth, gaussian index) sort key:

      key1 = [tile : tile_bits | depth_hi : d_hi]
      key2 = [depth_lo : d_lo  | gaussian_index : idx_bits]

    with depth normalized to ``sortable(depth) - near_key``.  Each gaussian
    emits at most one instance per tile, so live key pairs are unique and an
    unstable sort reproduces the reference's stable tie order (input index).
    """

    d_hi: int
    d_lo: int
    idx_bits: int
    near_key: int
    span: int

    @property
    def kernel_tuple(self):
        return (self.d_hi, self.d_lo, self.idx_bits)

    def normalize(self, depth_word):
        """Order-preserving, saturating depth-word normalization of an int64
        tensor holding u32 sortable depth words."""
        d = depth_word & U32
        return torch.clamp(torch.clamp(d, min=self.near_key) - self.near_key,
                           max=self.span)


def make_key_plan(num_tiles: int, n_gaussians: int, *,
                  near_plane: float | None = None,
                  far_plane: float | None = None,
                  depth_span_bits: int | None = None) -> KeyPlan | None:
    """Build a tie-free :class:`KeyPlan`, or None when tile + depth-span +
    gaussian-index bits do not fit 64.  Depth bounds are widened to
    [near/4, far*4]."""
    if depth_span_bits is not None:
        near_key, span = 0, (1 << depth_span_bits) - 1
    else:
        near_key = _sortable_u32(max(near_plane, 1e-6) * 0.25)
        far_key = _sortable_u32(far_plane * 4.0)
        span = far_key - near_key
        if span <= 0:
            return None
    tile_bits = max(int(num_tiles).bit_length(), 1)
    idx_bits = max(int(n_gaussians - 1).bit_length(), 1)
    d_hi = 32 - tile_bits
    d_lo = max(int(span).bit_length() - d_hi, 0)
    if d_hi <= 0 or d_lo + idx_bits > 32:
        return None
    return KeyPlan(d_hi=d_hi, d_lo=d_lo, idx_bits=idx_bits,
                   near_key=near_key, span=span)


def pack_rect_word(min_tx, min_ty, rect_w):
    """Pack (min_tx, min_ty, rect_w) into one u32 word (10 | 10 | 10 bits),
    returned as int32 bits."""
    w = (min_tx.to(torch.int64) | (min_ty.to(torch.int64) << 10)
         | (rect_w.to(torch.int64) << 20))
    return to_i32(w)


def extract_tile_ranges(sorted_tile, num_tiles: int):
    """Per-tile (start, count) of a tile-sorted int64 key array (sentinels
    sort after every real tile): one binary search over num_tiles + 1
    boundaries.  Returns int32 tensors."""
    tiles = torch.arange(num_tiles + 1, dtype=torch.int64,
                         device=sorted_tile.device)
    bounds = torch.searchsorted(sorted_tile, tiles, side="left").to(torch.int32)
    return bounds[:-1], bounds[1:] - bounds[:-1]
