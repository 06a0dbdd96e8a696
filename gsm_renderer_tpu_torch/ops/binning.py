"""Sort-key planning, rect packing, the two-sort instance order and
tile-range extraction.

PyTorch counterpart of ``gsm_renderer_tpu/ops/binning.py``.  Word tensors are
int32 holding the u32 bits; arithmetic that needs the unsigned value widens
to int64 (``mathlib.u32``), and u32 keys are carried as int64 (the
sentinel 0xFFFFFFFF sorts after every real key).

Besides the KeyPlan, the module keeps the reference's own two-sort
DepthFirst order as plain torch functions on the inputs' device: a stable
depth sort of the gaussians (:func:`depth_order`), the inverse expansion
slot -> (rank, j) (:func:`build_slot_map`), each slot's tile
(:func:`slot_tile_ids`), a stable tile sort (:func:`stable_sort_by_tile`),
then :func:`extract_tile_ranges` and :func:`gather_sorted_records`.
Stable at each step, it gives the KeyPlan order; the frames do not run it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mathlib import U32, to_i32, u32

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

    @property
    def lift(self) -> int:
        """The zero gap above depth_lo in key2, 32 - d_lo - idx_bits bits:
        the sort key pack lifts depth_lo over it (``kernels/sort.py``)."""
        return 32 - self.d_lo - self.idx_bits

    @property
    def sort_begin_bit(self) -> int:
        """The lowest bit of the lifted int64 sort key that orders slots,
        32 - d_lo: the index below it only breaks ties, which the order
        the expand writes slots in already breaks."""
        return 32 - self.d_lo

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


def unpack_rect_word(word):
    """(min_tx, min_ty, rect_w) int32 of packed rect words (int32 bits or
    int64 u32 values)."""
    w = u32(word)
    return ((w & 0x3FF).to(torch.int32), ((w >> 10) & 0x3FF).to(torch.int32),
            ((w >> 20) & 0x3FF).to(torch.int32))


def depth_order(depth_key):
    """Stable depth sort of the gaussians; culled keys (0xFFFFFFFF) sink to
    the end.  Returns (sorted_key (N,) int64 u32 values, order (N,) int32),
    ``order[i]`` the gaussian at depth rank i (ties in input order)."""
    sorted_key, order = torch.sort(u32(depth_key), stable=True)
    return sorted_key, order.to(torch.int32)


@dataclasses.dataclass
class SlotMap:
    """Inverse expansion mapping over the instance capacity C."""

    rank: torch.Tensor        # (C,) int32: the owning gaussian rank
    j: torch.Tensor           # (C,) int32: the within-rect index (row-major)
    slot_valid: torch.Tensor  # (C,) bool: slot < total emitted instances
    total: torch.Tensor       # () int32: total instances (before the clamp)
    overflow: torch.Tensor    # () int32: 1 if total exceeds the capacity


def build_slot_map(counts, capacity: int) -> SlotMap:
    """Invert per-gaussian instance counts (N,) in emission order (depth
    order for the DepthFirst frame) into per-slot (rank, j) over
    ``capacity`` slots: each gaussian with a count marks its offset with its
    rank (the largest where several share one), a running maximum spreads
    the marks, and j = slot - offset[rank].  rank and j stay unmasked past
    the total (rank nondecreasing); consumers mask with ``slot_valid``."""
    counts = counts.to(torch.int32)
    dev = counts.device
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts  # exclusive
    total = offsets[-1] + counts[-1]
    mark = (counts > 0) & (offsets < capacity)
    rank_at = torch.zeros(capacity, dtype=torch.int32, device=dev)
    rank_at.scatter_reduce_(
        0, offsets[mark].to(torch.int64),
        torch.arange(counts.shape[0], dtype=torch.int32, device=dev)[mark],
        reduce="amax")
    rank = torch.cummax(rank_at, 0).values
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)
    return SlotMap(rank=rank, j=slot - offsets[rank.to(torch.int64)],
                   slot_valid=slot < total, total=total,
                   overflow=(total > capacity).to(torch.int32))


def slot_tile_ids(slot_map: SlotMap, rect_word_by_rank, tiles_x: int):
    """Each slot's tile id (C,) int64 from the rect word of its rank
    (``rect_word_by_rank`` (N,) in the emission order of the counts): row
    j // rect_w and column j % rect_w of the rect; dead slots carry
    SENTINEL_KEY.  No per-tile test (the frame applies it later)."""
    word = rect_word_by_rank[torch.clamp(slot_map.rank, min=0).to(torch.int64)]
    min_tx, min_ty, rect_w = (x.to(torch.int64) for x in unpack_rect_word(word))
    rect_w = torch.clamp(rect_w, min=1)
    j = slot_map.j.to(torch.int64)
    q = torch.div(j, rect_w, rounding_mode="floor")
    tile = (min_ty + q) * tiles_x + min_tx + j - q * rect_w
    return torch.where(slot_map.slot_valid, tile, SENTINEL_KEY)


def stable_sort_by_tile(tile_key, payload):
    """Stable sort of instances by tile key (int64 u32 values): the
    emission (depth) order stays within each tile.  Returns (sorted_key,
    sorted_payload)."""
    sorted_key, perm = torch.sort(tile_key, stable=True)
    return sorted_key, payload[perm]


def gather_sorted_records(sorted_payload, record_words):
    """Rows of the (N, K) record-word table in sorted-instance order
    (``sorted_payload`` (C,) indices into it; negative ones read row 0)."""
    return record_words[torch.clamp(sorted_payload, min=0).to(torch.int64)]


def extract_tile_ranges(sorted_tile, num_tiles: int):
    """Per-tile (start, count) of a tile-sorted int64 key array (sentinels
    sort after every real tile): one binary search over num_tiles + 1
    boundaries.  Returns int32 tensors."""
    tiles = torch.arange(num_tiles + 1, dtype=torch.int64,
                         device=sorted_tile.device)
    bounds = torch.searchsorted(sorted_tile, tiles, side="left").to(torch.int32)
    return bounds[:-1], bounds[1:] - bounds[:-1]
