"""The instance sort on the int64 keys alone: the key pack, the keys-only
radix sort and the tile ranges.

The KeyPlan frames sort their slots by the (key1, key2) pair of the expand
(``kernels/expand.py``) as one int64 key, ``((key1 ^ 0x80000000) << 32) |
key2`` (:func:`sort_key64`), and the blend reads each rank's entry through
the sorted key's low bits, so only the keys are sorted: no index or payload
rides along.  Three steps, each with its CUDA kernel (``csrc/sort.cu``) and
a plain version for CPU tensors, which is the PyTorch code the kernel
replaces on the card:

- :func:`sort_key_pack`: the int64 keys from the two int32 planes (plain:
  :func:`sort_key64`);
- :func:`sort_keys_only`: CUB's keys-only LSD radix sort over all 64 bits
  on the card (``cub::DeviceRadixSort::SortKeys``; the plain version is
  ``torch.sort``: the sorted values are the same, bit for bit);
- :func:`sort_ranges`: each tile's (start, count) of the sorted keys from
  one read of them; the tile of a key is ``key1 >> shift`` (``shift`` the
  KeyPlan's ``d_hi``, or 0 for the stable fallback's plain tile key), and
  the sentinel's, or any tile id at or past ``num_tiles``, lies past every
  tile; the counts, clamped to a frame's ``max_per_tile`` where it has one,
  and their sum, the header's ``total_instances`` (plain:
  :func:`binning_sorted_tile`, then ``ops.binning.extract_tile_ranges``,
  ``torch.clamp`` and the sum).

The JAX package leaves the sort to ``jax.lax.sort`` and the ranges to an XLA
``searchsorted``: neither is a Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _native
from .. import mathlib as M
from ..ops import binning as B
from .expand import SENTINEL

PACK = _native.Kernel("sort_pack", "sort", "gsm_sort_key_pack", [
    _native.P, _native.P, _native.I, _native.P])
SORT = _native.Kernel("sort_keys", "sort", "gsm_sort_keys", [
    _native.P, _native.P, _native.I, _native.P, ctypes.c_size_t, _native.P])
RANGES = _native.Kernel("sort_ranges", "sort", "gsm_sort_ranges", [
    _native.P, _native.I, _native.I, _native.I, _native.I, _native.P,
    _native.P])

#: n -> CUB's temporary storage bytes for n keys
_temp_bytes: dict = {}


def sort_key64(key1, key2):
    """The int64 key whose signed order is the unsigned (key1, key2) order;
    the plain version of the pack kernel."""
    return ((M.u32(key1) ^ 0x80000000) << 32) | M.u32(key2)


def sort_key_pack_cuda(key1, key2):
    """Launch the pack kernel of ``csrc/sort.cu``: one pass over the planes,
    16-B loads and stores where both planes are 16-B aligned."""
    n = key1.shape[0]
    dev = key1.device
    _native.check(key1, "key1", torch.int32, (n,), dev)
    _native.check(key2, "key2", torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    PACK.launch(_native.ptr(key1), _native.ptr(key2), n, _native.ptr(out))
    return out


def sort_key_pack(key1, key2):
    """The int64 sort keys: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if key1.is_cuda:
        return sort_key_pack_cuda(key1, key2)
    return sort_key64(key1, key2)


def sort_keys_only_plain(keys):
    """Plain version of the keys-only sort: ``torch.sort``'s values."""
    return torch.sort(keys, stable=False).values


def _sort_temp_bytes(n: int) -> int:
    nbytes = _temp_bytes.get(n)
    if nbytes is None:
        fn = _native.load("sort").gsm_sort_keys_temp_bytes
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
        fn.restype = ctypes.c_int
        out = ctypes.c_size_t(0)
        err = fn(n, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"gsm_sort_keys_temp_bytes: CUDA error {err}")
        nbytes = _temp_bytes[n] = max(int(out.value), 1)
    return nbytes


def sort_keys_only_cuda(keys):
    """CUB's keys-only radix sort of the (C,) int64 ``keys`` over bits [0,
    64) (``gsm_sort_keys``).  It ping-pongs between ``keys`` and a second
    buffer of C keys, so ``keys`` is overwritten; returns whichever holds
    the sorted keys.  Holds 16 B a slot and CUB's small temporary storage."""
    n = keys.shape[0]
    dev = keys.device
    _native.check(keys, "keys", torch.int64, (n,), dev)
    alt = torch.empty_like(keys)
    temp = torch.empty(_sort_temp_bytes(n), dtype=torch.uint8, device=dev)
    selector = ctypes.c_int(0)
    SORT.launch(_native.ptr(keys), _native.ptr(alt), n, _native.ptr(temp),
                temp.numel(), ctypes.addressof(selector))
    return alt if selector.value else keys


def sort_keys_only(keys):
    """The sorted int64 keys: CUB for CUDA tensors (overwriting ``keys``),
    ``torch.sort`` for CPU tensors."""
    if keys.is_cuda:
        return sort_keys_only_cuda(keys)
    return sort_keys_only_plain(keys)


def _check_ranges(num_tiles: int, shift: int, max_per_tile: int):
    if num_tiles < 1 or not 0 <= shift <= 31 or max_per_tile < 0:
        raise ValueError(f"tile ranges take num_tiles >= 1, a shift of 0 to "
                         f"31 and max_per_tile >= 0, got {num_tiles}, "
                         f"{shift} and {max_per_tile}")


def binning_sorted_tile(sorted_key, *, plan_tuple):
    """Sorted tile ids (int64; SENTINEL for dead slots) from the sorted
    int64 keys; ``plan_tuple`` a KeyPlan's kernel tuple, whose first entry
    is the tile id's shift in key1, or None for the stable fallback's plain
    tile key."""
    k1 = ((sorted_key >> 32) & M.U32) ^ 0x80000000
    shift = 0 if plan_tuple is None else plan_tuple[0]
    return torch.where(k1 == SENTINEL, SENTINEL, k1 >> shift)


def sort_ranges_plain(sorted_key, num_tiles: int, shift: int,
                      max_per_tile: int = 0):
    """Plain version of the ranges kernels: (starts, counts, total) int32 of
    each tile's span of the sorted int64 keys, by a binary search of the
    sorted tile ids; the counts clamped to ``max_per_tile`` where it is
    above 0, and ``total`` (0-d) their sum."""
    _check_ranges(num_tiles, shift, max_per_tile)
    starts, counts = B.extract_tile_ranges(
        binning_sorted_tile(sorted_key, plan_tuple=(shift,)), num_tiles)
    if max_per_tile > 0:
        counts = torch.clamp(counts, max=max_per_tile)
    return starts, counts, counts.sum().to(torch.int32)


def sort_ranges_cuda(sorted_key, num_tiles: int, shift: int,
                     max_per_tile: int = 0):
    """Launch the ranges kernels of ``csrc/sort.cu``: the num_tiles + 1 tile
    boundaries from one read of the sorted keys, then the counts (clamped
    to ``max_per_tile`` where it is above 0) and their sum beside them.
    Returns (starts, a view of the boundaries; counts; the sum, a 0-d view
    after the counts)."""
    _check_ranges(num_tiles, shift, max_per_tile)
    n = sorted_key.shape[0]
    dev = sorted_key.device
    _native.check(sorted_key, "sorted_key", torch.int64, (n,), dev)
    bounds = torch.empty(num_tiles + 1, dtype=torch.int32, device=dev)
    counts = torch.empty(num_tiles + 1, dtype=torch.int32, device=dev)
    RANGES.launch(_native.ptr(sorted_key), n, num_tiles, shift, max_per_tile,
                  _native.ptr(bounds), _native.ptr(counts))
    return bounds[:num_tiles], counts[:num_tiles], counts[num_tiles]


def sort_ranges(sorted_key, num_tiles: int, shift: int,
                max_per_tile: int = 0):
    """Tile ranges of the sorted int64 keys, (starts, counts, the counts'
    sum), the counts clamped to ``max_per_tile`` where it is above 0: the
    CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    if sorted_key.is_cuda:
        return sort_ranges_cuda(sorted_key, num_tiles, shift, max_per_tile)
    return sort_ranges_plain(sorted_key, num_tiles, shift, max_per_tile)
