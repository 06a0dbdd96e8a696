"""The instance sort on the int64 keys alone: the key pack, the keys-only
radix sort and the tile ranges.

The KeyPlan frames sort their slots by the (key1, key2) pair of the expand
(``kernels/expand.py``) as one int64 key, ``((key1 ^ 0x80000000) << 32) |
key2'`` (:func:`sort_key64`), and the blend reads each rank's entry through
the sorted key's low bits, so only the keys are sorted: no index or payload
rides along.  Three steps, each with its CUDA kernel (``csrc/sort.cu``) and
a plain version for CPU tensors, which is the PyTorch code the kernel
replaces on the card:

- :func:`sort_key_pack`: the int64 keys from the two int32 planes (plain:
  :func:`sort_key64`), key2' being key2 with the bits above its low
  ``idx_bits`` lifted by ``lift``: a KeyPlan's ``lift`` moves depth_lo over
  the zero gap above it to the top of the low word, so that the bits that
  order slots are the one run from the plan's ``sort_begin_bit`` up (lift
  0: key2 itself, the stable fallback's pack);
- :func:`sort_keys_only`: CUB's keys-only LSD radix sort over bits
  [``begin_bit``, 64) on the card (``cub::DeviceRadixSort::SortKeys``, one
  pass per :data:`RADIX_BITS` bits, :func:`radix_passes`); the plain
  version is ``torch.sort`` of the whole key.  The two give the same array,
  bit for bit, where the keys are a frame's: within a tile the expand
  writes live slots in strictly rising entry index, CUB's sort is stable,
  so the bits below ``begin_bit`` (the index) need no pass; live keys are
  unique, so the unstable whole-key sort orders them the same way; dead
  slots are the one sentinel key.  The card's sort counts its passes
  (``sort_radix_passes``), and :func:`measured_radix_passes` reads them off
  a captured sort's graph;
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
from ..profiling import count
from .expand import SENTINEL

PACK = _native.Kernel("sort_pack", "sort", "gsm_sort_key_pack", [
    _native.P, _native.P, _native.I, _native.I, _native.I, _native.P])
SORT = _native.Kernel("sort_keys", "sort", "gsm_sort_keys", [
    _native.P, _native.P, _native.I, _native.P, ctypes.c_size_t, _native.I,
    _native.P])
RANGES = _native.Kernel("sort_ranges", "sort", "gsm_sort_ranges", [
    _native.P, _native.I, _native.I, _native.I, _native.I, _native.P,
    _native.P])

#: the key bits CUB's radix sort of int64 keys takes a pass (its onesweep
#: digit)
RADIX_BITS = 8

#: (n, begin_bit) -> CUB's temporary storage bytes for n keys
_temp_bytes: dict = {}


def radix_passes(begin_bit: int) -> int:
    """The passes over the keys of CUB's radix sort of bits [``begin_bit``,
    64): 8 for the whole key, 5 from bit 24, 4 from bit 32."""
    return -(-(64 - begin_bit) // RADIX_BITS)


def _check_lift(idx_bits: int, lift: int):
    if not (0 <= idx_bits <= 32 and 0 <= lift <= 31):
        raise ValueError(f"the key pack takes 0 to 32 index bits and a lift "
                         f"of 0 to 31, got {idx_bits} and {lift}")


def lift_low_word(key2, lift: int, idx_bits: int):
    """u32 ``key2`` (int64 tensor) with its bits above the low ``idx_bits``
    moved up by ``lift``, those pushed past bit 31 dropped (only the
    sentinel has any: the plan's gap is zero in live slots); ``lift`` 0
    returns ``key2``."""
    if lift == 0:
        return key2
    mask = (1 << idx_bits) - 1
    return (key2 & mask) | (((key2 & (M.U32 ^ mask)) << lift) & M.U32)


def sort_key64(key1, key2, lift: int = 0, idx_bits: int = 0):
    """The int64 key whose signed order is the unsigned (key1, key2') order,
    key2' being key2 lifted by :func:`lift_low_word`; the plain version of
    the pack kernel."""
    _check_lift(idx_bits, lift)
    return (((M.u32(key1) ^ 0x80000000) << 32)
            | lift_low_word(M.u32(key2), lift, idx_bits))


def sort_key_pack_cuda(key1, key2, lift: int = 0, idx_bits: int = 0):
    """Launch the pack kernel of ``csrc/sort.cu``: one pass over the planes,
    16-B loads and stores where both planes are 16-B aligned."""
    _check_lift(idx_bits, lift)
    n = key1.shape[0]
    dev = key1.device
    _native.check(key1, "key1", torch.int32, (n,), dev)
    _native.check(key2, "key2", torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    PACK.launch(_native.ptr(key1), _native.ptr(key2), n, idx_bits, lift,
                _native.ptr(out))
    return out


def sort_key_pack(key1, key2, lift: int = 0, idx_bits: int = 0):
    """The int64 sort keys, key2's bits above its low ``idx_bits`` lifted by
    ``lift``: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if key1.is_cuda:
        return sort_key_pack_cuda(key1, key2, lift, idx_bits)
    return sort_key64(key1, key2, lift, idx_bits)


def sort_keys_only_plain(keys):
    """Plain version of the keys-only sort: ``torch.sort``'s values over the
    whole key."""
    return torch.sort(keys, stable=False).values


def _sort_temp_bytes(n: int, begin_bit: int) -> int:
    nbytes = _temp_bytes.get((n, begin_bit))
    if nbytes is None:
        fn = _native.load("sort").gsm_sort_keys_temp_bytes
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_size_t)]
        fn.restype = ctypes.c_int
        out = ctypes.c_size_t(0)
        err = fn(n, begin_bit, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"gsm_sort_keys_temp_bytes: CUDA error {err}")
        nbytes = _temp_bytes[n, begin_bit] = max(int(out.value), 1)
    return nbytes


def _check_begin_bit(begin_bit: int):
    if not 0 <= begin_bit <= 63:
        raise ValueError(f"the keys-only sort takes a begin bit of 0 to 63, "
                         f"got {begin_bit}")


def sort_keys_only_cuda(keys, begin_bit: int = 0):
    """CUB's keys-only radix sort of the (C,) int64 ``keys`` over bits
    [``begin_bit``, 64) (``gsm_sort_keys``; stable: keys equal in those
    bits keep their order).  It ping-pongs between ``keys`` and a second
    buffer of C keys, so ``keys`` is overwritten; returns whichever holds
    the sorted keys.  Holds 16 B a slot and CUB's small temporary storage."""
    _check_begin_bit(begin_bit)
    n = keys.shape[0]
    dev = keys.device
    _native.check(keys, "keys", torch.int64, (n,), dev)
    alt = torch.empty_like(keys)
    temp = torch.empty(_sort_temp_bytes(n, begin_bit), dtype=torch.uint8,
                       device=dev)
    selector = ctypes.c_int(0)
    SORT.launch(_native.ptr(keys), _native.ptr(alt), n, _native.ptr(temp),
                temp.numel(), begin_bit, ctypes.addressof(selector))
    count("sort_radix_passes", radix_passes(begin_bit))
    return alt if selector.value else keys


def graph_nodes(fn) -> tuple:
    """(kernel nodes, memset nodes) of one call of ``fn`` captured into a
    CUDA graph, read back through libcuda's graph API; the captured work
    does not run."""
    cu = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=torch.cuda.Stream()):
        fn()
    handle = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    g.reset()
    # CU_GRAPH_NODE_TYPE_KERNEL 0, CU_GRAPH_NODE_TYPE_MEMSET 2
    return types.count(0), types.count(2)


def measured_radix_passes(keys, begin_bit: int) -> int:
    """The passes over the CUDA ``keys`` that CUB's sort from ``begin_bit``
    makes, read off captured sorts and not worked out from the bits as
    :func:`radix_passes` is: CUB adds one onesweep kernel and one memset a
    pass to nodes that do not depend on the bits it sorts, and its sort of
    the top 8 bits makes one pass, so the passes are one more than the
    nodes a sort from ``begin_bit`` holds beyond that sort's.  Raises where
    the kernel and the memset nodes tell two counts.  ``keys`` is left as
    it is: the captured sorts do not run (the counters count them)."""
    top = 64 - RADIX_BITS
    nodes = {}
    for b in (top, begin_bit):
        _sort_temp_bytes(keys.shape[0], b)  # sized outside the capture
        nodes[b] = graph_nodes(lambda b=b: sort_keys_only_cuda(keys, b))
    kernels, memsets = (1 + x - y for x, y in zip(nodes[begin_bit],
                                                   nodes[top]))
    if kernels != memsets:
        raise RuntimeError(f"CUB's sort from bit {begin_bit}: {kernels} "
                           f"onesweep kernels but {memsets} memsets "
                           f"(nodes {nodes})")
    return kernels


def sort_keys_only(keys, begin_bit: int = 0):
    """The sorted int64 keys: CUB from ``begin_bit`` up for CUDA tensors
    (overwriting ``keys``), ``torch.sort`` of the whole key for CPU
    tensors."""
    if keys.is_cuda:
        return sort_keys_only_cuda(keys, begin_bit)
    _check_begin_bit(begin_bit)
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
