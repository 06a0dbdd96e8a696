"""The keys-only instance sort (``kernels/sort.py``): the key pack, the
keys-only radix sort and the tile ranges.

On the CPU: the plain pack (``sort_key64``) against the key's definition
computed in numpy, with and without a KeyPlan's lift of depth_lo, and the
plain ranges (``binning_sorted_tile`` +
``ops.binning.extract_tile_ranges``, torch.searchsorted) against a count of
each tile's keys in numpy, on built keys (key1 with bit 31 set and clear,
the sentinel, empty leading, middle and trailing tiles, all slots dead, one
slot, a band grid, shift 0, tile ids at and past the tile count); every
frame chain's sort and ranges (DepthFirst with rows and with
16-bit depth keys, Global, Local, Hardware, stereo, foveated, the band
chain, the stable fallback) against those yardsticks and
``torch.sort(sort_key64(...)).values`` of the lifted key; in every chain
the precondition of the sort from the plan's begin bit (live slots of a
tile in strictly rising entry index) and that sort itself (a stable sort
of ``lifted_key >> begin_bit``) against the whole-key sort; the counters
of the sort paths and of the radix passes.

On the card (marked ``card``): the CUDA pack, CUB's keys-only sort and the
ranges kernels bit-equal to the same yardsticks at sizes that are not a
multiple of a block, with planes that are not 16-B aligned and at 11M
slots (random keys: the whole key, begin bit 0); CUB from each plan's
begin bit on keys in the expand's slot order, bit-equal to the whole-key
sort at the same sizes and at the garden's 11M slots, and its passes (5
for the garden's plan, 4 for a d16 plan: the kernel and memset nodes of
captured sorts, and ``sort_radix_passes``, which CPU sorts leave at 0);
the ranges' clamped counts and their sum (the header's
``total_instances``) at the garden's shapes; the same chains on CUDA
tensors; each frame's pack, sort and ranges launches; and the header sums
that prep writes beside the offsets, bit-equal to the plain prep's in
every mode at 1M gaussians and at the garden's 5.8M, on the built
gaussians of tests/test_torch_header_sums.py, back to back at other sizes
(each launch's last block zeroes the accumulators for the next).  This
file imports no JAX, so that ``python -m pytest --noconftest
tests/test_torch_sort_keys.py`` runs it on a machine with a card and
without JAX."""

import os
import sys

import numpy as np
import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import mathlib as M
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians
from gsm_renderer_tpu_torch.kernels import expand as KE
from gsm_renderer_tpu_torch.kernels import sort as KS
from gsm_renderer_tpu_torch.ops import binning as B
from gsm_renderer_tpu_torch.parallel import multichip as MC
from gsm_renderer_tpu_torch.pipelines import common as PC

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_header_sums import (MODES, band_planes,  # noqa: E402
                                    built_inputs, i32, warped_bounds)

SENTINEL = KE.SENTINEL


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def i32(values):
    return torch.as_tensor(np.asarray(values, dtype=np.uint32).view(np.int32))


def plan_keys(rng, n, *, num_tiles, shift, dead=0.06, tiles=None):
    """(key1, key2) int32 of ``n`` slots: key1 = tile << shift | random low
    bits (tiles drawn from ``tiles``, default all of [0, num_tiles)), key2
    random, a ``dead`` share of the slots the sentinel in both."""
    tiles = np.arange(num_tiles) if tiles is None else np.asarray(tiles)
    t = rng.choice(tiles, size=n).astype(np.uint64)
    low = rng.integers(0, 1 << shift, size=n, dtype=np.uint64) if shift \
        else np.zeros(n, np.uint64)
    k1 = ((t << np.uint64(shift)) | low).astype(np.uint32)
    k2 = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    d = rng.random(n) < dead
    k1[d] = SENTINEL
    k2[d] = SENTINEL
    return i32(k1), i32(k2)


def yardstick_ranges(sorted_key, num_tiles, shift):
    """Today's ranges: the sorted tile ids, then torch.searchsorted."""
    tile = PC.binning_sorted_tile(
        sorted_key, plan_tuple=None if shift == 0 else (shift, 0, 0))
    return B.extract_tile_ranges(tile, num_tiles)


def numpy_key(key1, key2, lift=0, idx_bits=0):
    """The pack's definition: (u32(key1) ^ 2**31) in the high word, u32(key2)
    in the low with the d_lo = 32 - idx_bits - lift bits above its index
    moved to the top, read as int64."""
    hi = (key1.numpy().view(np.uint32) ^ np.uint32(1 << 31)).astype(np.uint64)
    lo = key2.numpy().view(np.uint32).astype(np.uint64)
    if lift:
        u, d_lo = np.uint64, 32 - idx_bits - lift
        top = ((lo >> u(idx_bits)) << u(32 - d_lo)) & u(0xFFFFFFFF)
        lo = (lo & u((1 << idx_bits) - 1)) | top
    return torch.from_numpy(((hi << np.uint64(32)) | lo).view(np.int64))


def numpy_ranges(sorted_key, num_tiles, shift):
    """Each tile's (start, count) by counting its keys: the tile of a key is
    key1 >> shift, the sentinel's and any past the count lie past them."""
    k1 = (sorted_key.numpy().view(np.uint64) >> np.uint64(32)).astype(
        np.uint32) ^ np.uint32(1 << 31)
    tile = np.where(k1 == SENTINEL, num_tiles,
                    np.minimum(k1 >> np.uint32(shift), num_tiles))
    counts = np.bincount(tile.astype(np.int64),
                         minlength=num_tiles + 1)[:num_tiles]
    return (torch.from_numpy((np.cumsum(counts) - counts).astype(np.int32)),
            torch.from_numpy(counts.astype(np.int32)))


def assert_ranges(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


# -- key cases: (num_tiles, shift, key1, key2) --------------------------------

def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "bit31_set":  # upper tile ids: key1 >= 2**31
        return 3, 30, *plan_keys(rng, 3000, num_tiles=4, shift=30,
                                 tiles=[2, 3], dead=0.0)
    if name == "bit31_clear":
        return 2, 30, *plan_keys(rng, 3000, num_tiles=2, shift=30, dead=0.0)
    if name == "sentinel":
        return 120, 19, *plan_keys(rng, 5000, num_tiles=120, shift=19, dead=0.4)
    if name == "empty_leading":
        return 64, 20, *plan_keys(rng, 4000, num_tiles=64, shift=20,
                                  tiles=np.arange(17, 64))
    if name == "empty_middle":
        return 64, 20, *plan_keys(rng, 4000, num_tiles=64, shift=20,
                                  tiles=[*range(0, 9), *range(40, 64)])
    if name == "empty_trailing":
        return 64, 20, *plan_keys(rng, 4000, num_tiles=64, shift=20,
                                  tiles=np.arange(0, 23))
    if name == "all_dead":
        return 64, 20, *plan_keys(rng, 777, num_tiles=64, shift=20, dead=1.0)
    if name == "one_slot":
        return 64, 20, *plan_keys(rng, 1, num_tiles=64, shift=20, dead=0.0)
    if name == "one_dead_slot":
        return 64, 20, *plan_keys(rng, 1, num_tiles=64, shift=20, dead=1.0)
    if name == "band_grid":  # tiles_x x bands of a band frame: 120 x 17
        return 120 * 17, 21, *plan_keys(rng, 9000, num_tiles=120 * 17,
                                        shift=21)
    if name == "shift_0":  # the stable fallback's plain tile key
        return 300, 0, *plan_keys(rng, 6000, num_tiles=300, shift=0)
    if name == "past_num_tiles":  # tile ids at and past the tile count
        return 40, 24, *plan_keys(rng, 3000, num_tiles=60, shift=24)
    raise KeyError(name)


CASES = ["bit31_set", "bit31_clear", "sentinel", "empty_leading",
         "empty_middle", "empty_trailing", "all_dead", "one_slot",
         "one_dead_slot", "band_grid", "shift_0", "past_num_tiles"]


@pytest.mark.parametrize("name", CASES)
def test_plain_pack_is_sort_key64(name):
    _nt, _shift, k1, k2 = _case(name)
    got = KS.sort_key_pack(k1, k2)
    assert got.dtype == torch.int64
    assert torch.equal(got, PC.sort_key64(k1, k2))
    assert torch.equal(got, numpy_key(k1, k2))


#: (idx_bits, lift) of the pack: the garden's plan (d_lo 8), a rows plan
#: with 24 index bits (no gap), a d16 plan (d_lo 0), a small frame's plan
LIFTS = [(23, 1), (24, 0), (23, 9), (10, 20)]


@pytest.mark.parametrize("idx_bits, lift", LIFTS)
@pytest.mark.parametrize("name", ["sentinel", "bit31_set", "band_grid"])
def test_plain_pack_lifts_depth_lo(name, idx_bits, lift):
    """The pack with a lift keeps key1 and the index field and puts the
    bits above the index at the top of the low word, the sentinel's too;
    lift 0 is the plain key whatever the index bits."""
    _nt, _shift, k1, k2 = _case(name)
    got = KS.sort_key_pack(k1, k2, lift, idx_bits)
    assert torch.equal(got, numpy_key(k1, k2, lift, idx_bits))
    mask = (1 << idx_bits) - 1
    assert torch.equal(got & mask, M.u32(k2) & mask)
    assert torch.equal(got >> 32, PC.sort_key64(k1, k2) >> 32)
    dead = M.u32(k2) == SENTINEL
    if name == "sentinel":
        assert bool(dead.any())
        top = ((1 << (32 - idx_bits - lift)) - 1) << (idx_bits + lift)
        assert bool(torch.all((got[dead] & M.U32) == mask | top))
    assert torch.equal(KS.sort_key_pack(k1, k2, 0, idx_bits),
                       PC.sort_key64(k1, k2))


def test_pack_and_sort_refuse_bad_arguments():
    k = torch.zeros(4, dtype=torch.int32)
    for idx_bits, lift in ((33, 0), (-1, 0), (8, 32), (8, -1)):
        with pytest.raises(ValueError):
            KS.sort_key_pack(k, k, lift, idx_bits)
    for begin_bit in (-1, 64):
        with pytest.raises(ValueError):
            KS.sort_keys_only(k.long(), begin_bit)


@pytest.mark.parametrize("begin_bit, passes", [(0, 8), (24, 5), (32, 4),
                                               (57, 1), (63, 1)])
def test_radix_passes(begin_bit, passes):
    assert KS.radix_passes(begin_bit) == passes


def test_garden_plans_sort_from_bit_24():
    """The garden cells' plans (1920x1080 and 1703x958 eye grids, near 0.1,
    far 100, 5.8M gaussians) sort 40 bits in 5 passes, the d16 plan 32
    bits in 4."""
    for num_tiles in (8160, 107 * 60):
        plan = B.make_key_plan(num_tiles, 5_800_000, near_plane=0.1,
                               far_plane=100.0)
        assert (plan.d_hi, plan.d_lo, plan.idx_bits, plan.lift) == \
            (19, 8, 23, 1)
        assert plan.sort_begin_bit == 24
        assert KS.radix_passes(plan.sort_begin_bit) == 5
    plan = PC.d16_key_plan(8160, 5_800_000)
    assert (plan.d_lo, plan.lift, plan.sort_begin_bit) == (0, 9, 32)
    assert KS.radix_passes(plan.sort_begin_bit) == 4


@pytest.mark.parametrize("name", CASES)
def test_plain_ranges_are_searchsorted(name):
    num_tiles, shift, k1, k2 = _case(name)
    sorted_key = torch.sort(PC.sort_key64(k1, k2)).values
    got = KS.sort_ranges(sorted_key, num_tiles, shift)
    assert_ranges(got, yardstick_ranges(sorted_key, num_tiles, shift))
    assert_ranges(got, numpy_ranges(sorted_key, num_tiles, shift))
    assert int(got[1].sum()) <= k1.shape[0]
    assert got[2].dtype == torch.int32 and got[2].shape == ()
    assert int(got[2]) == int(got[1].sum())


def test_empty_tiles_read_as_empty():
    """The leading, middle and trailing empty tiles of the cases start where
    the next live tile does and count 0."""
    num_tiles, shift, k1, k2 = _case("empty_middle")
    starts, counts, _total = KS.sort_ranges_plain(
        torch.sort(PC.sort_key64(k1, k2)).values, num_tiles, shift)
    assert torch.all(counts[9:40] == 0)
    assert torch.all(starts[9:40] == starts[40])
    assert int(starts[0]) == 0
    _, _, k1, k2 = _case("all_dead")
    starts, counts, total = KS.sort_ranges_plain(
        torch.sort(PC.sort_key64(k1, k2)).values, 64, 20)
    assert torch.all(starts == 0) and torch.all(counts == 0)
    assert int(total) == 0


def test_ranges_refuse_bad_arguments():
    key = torch.zeros(4, dtype=torch.int64)
    for num_tiles, shift, most in ((0, 3, 0), (4, -1, 0), (4, 32, 0),
                                   (4, 3, -1)):
        with pytest.raises(ValueError):
            KS.sort_ranges(key, num_tiles, shift, most)


def test_sort_keys_empties_a_list_of_planes():
    """sort_keys takes the list of planes over and empties it (their memory
    is free before the sort takes its second buffer), on either path."""
    plan = B.make_key_plan(64, 1000, near_plane=0.1, far_plane=100.0)
    _, _, k1, k2 = _case("sentinel")
    keys = [k1, k2]
    got, blend_key, idx_bits = PC.sort_keys(keys, plan)
    assert keys == [] and blend_key is got and idx_bits == plan.idx_bits
    assert torch.equal(got, torch.sort(
        PC.sort_key64(k1, k2, plan.lift, plan.idx_bits)).values)
    entry = torch.arange(k1.shape[0], dtype=torch.int32)
    keys = [k1, k2, entry]
    got, sorted_entry, idx_bits = PC.sort_keys(keys, None)
    assert keys == [] and idx_bits == 32
    want, perm = torch.sort(PC.sort_key64(k1, k2), stable=True)
    assert torch.equal(got, want) and torch.equal(sorted_entry, perm)


# -- every frame chain's sort and ranges against the yardsticks ------------

W, H = 96, 64


def _scene(device, n=600, seed=5):
    ds = generate_visible_gaussians(n, sh_degree=1, seed=seed,
                                    scale_range=(0.01, 0.06))
    return ds.to_input(device=device)


@pytest.fixture
def recorded(monkeypatch):
    """Every sort_keys / tile_ranges call of the frames: the planes (copied
    before the sort empties the list), the plan, the sorted keys and the
    ranges."""
    calls = []
    sort_keys, tile_ranges = PC.sort_keys, PC.tile_ranges

    def record_sort(keys, key_plan):
        planes = [k.clone() for k in keys]
        out = sort_keys(keys, key_plan)
        calls.append(dict(planes=planes, plan=key_plan, sorted=out[0]))
        return out

    def record_ranges(sorted_key, plan, num_tiles, max_per_tile=0):
        out = tile_ranges(sorted_key, plan, num_tiles, max_per_tile)
        calls[-1].update(num_tiles=num_tiles, ranges=out)
        return out

    monkeypatch.setattr(PC, "sort_keys", record_sort)
    monkeypatch.setattr(PC, "tile_ranges", record_ranges)
    return calls


def _band_chain(gi, cam, w, h):
    """One band rank's chain (parallel/multichip.py): the projection block,
    prep "band", the expand at the band's tile row offset, then
    sort_and_ranges over the tiles_x x bands grid: the two tile rows above
    the middle one (1 and 2 of 4 at (W, H))."""
    tiles_x = -(-w // 16)
    band0 = -(-h // 16) // 2 - 1
    band1 = band0 + 2
    block = MC.project_block(
        gi, cam.view_matrix, cam.projection_matrix, cam.position, width=w,
        height=h, tile_w=16, tile_h=16, sh_degree=1,
        near_plane=cam.near_plane, far_plane=cam.far_plane,
        alpha_threshold=0.005, total_ink_threshold=2.0, input_is_srgb=False)
    bands = band1 - band0
    plan = B.make_key_plan(tiles_x * bands, gi.count,
                           near_plane=cam.near_plane, far_plane=cam.far_plane)
    offsets, rect, mask, dsw, _sums = KE.binning_prep_band(
        block[4], block[5], block[6], block[7], band0=band0, band1=band1,
        key_plan=plan)
    *keys, _total, overflow = KE.expand_slots(
        offsets, rect, mask, dsw, list(block[:4]), capacity=16 * 4096,
        tiles_x=tiles_x, key_plan=plan, mode="mono", tile_row_offset=band0)
    assert int(overflow) == 0
    return PC.sort_and_ranges(keys, plan, tiles_x * bands)


def _render(chain, device, size=(W, H)):
    w, h = size
    gi, cam = _scene(device), T.make_camera(w, h, far=20.0)
    config = dict(sh_degree=1, max_width=w, max_height=h)
    if chain == "band":
        return _band_chain(gi, cam, w, h)
    if chain == "mono":
        config["row_expand"] = False
    cls = {"global": T.GlobalRenderer, "local": T.LocalRenderer,
           "hardware": T.HardwareRenderer}.get(chain, T.DepthFirstRenderer)
    if chain == "d16":
        config["depth_sort_key_precision"] = T.DepthSortKeyPrecision.BITS16
    r = cls(T.RendererConfig(**config), device=device)
    stereo = T.make_side_by_side_stereo(cam)
    if chain == "stereo":
        return r.render_stereo(gi, stereo, w, h)
    if chain == "foveated":
        return r.render_stereo_foveated(
            gi, stereo, T.make_rate_maps(w, h, min_rate=0.4, radius=0.3))
    return r.render(gi, cam, w, h)


CHAINS = ["rows", "mono", "d16", "global", "local", "hardware", "stereo",
          "foveated", "band"]


def lifted_key(planes, plan):
    """The int64 key the KeyPlan frames sort: the pack with the plan's
    lift."""
    return PC.sort_key64(planes[0], planes[1], plan.lift, plan.idx_bits)


def check_calls(calls):
    assert calls
    for c in calls:
        plan = c["plan"]
        k1, k2 = c["planes"][:2]
        if plan is None:
            want = torch.sort(PC.sort_key64(k1, k2), stable=True).values
        else:
            want = torch.sort(lifted_key(c["planes"], plan)).values
        assert torch.equal(c["sorted"], want)
        shift = 0 if plan is None else plan.d_hi
        assert_ranges(c["ranges"],
                      yardstick_ranges(c["sorted"], c["num_tiles"], shift))


@pytest.mark.parametrize("chain", CHAINS)
def test_chain_sort_and_ranges(chain, recorded):
    _render(chain, "cpu")
    check_calls(recorded)
    assert all(c["plan"] is not None for c in recorded)


#: a frame whose tile grid leaves depth_lo bits in key2 (d_lo > 0 but in the
#: d16 chains), so that the lift moves them; at (W, H) d_lo is 0
WIDE = (512, 256)


@pytest.mark.parametrize("chain", CHAINS)
def test_chain_slots_rise_in_entry_within_a_tile(chain, recorded):
    """The precondition of the sort from the plan's begin bit: in the
    expand's output the live slots of each tile come in strictly rising
    entry index (an entry owns at most one slot a tile, and slots follow
    the entries' prefix offsets)."""
    _render(chain, "cpu", WIDE)
    assert recorded
    for c in recorded:
        plan = c["plan"]
        k1, k2 = (M.u32(k) for k in c["planes"][:2])
        live = k1 != SENTINEL
        tile = (k1 >> plan.d_hi)[live]
        entry = (k2 & ((1 << plan.idx_bits) - 1))[live]
        assert live.sum() > 100
        order = torch.sort(tile, stable=True).indices
        t, e = tile[order], entry[order]
        same = t[1:] == t[:-1]
        assert bool(torch.all(e[1:][same] > e[:-1][same]))


@pytest.mark.parametrize("chain", CHAINS)
def test_chain_begin_bit_sort_is_the_whole_key_sort(chain, recorded):
    """A stable sort of the lifted key's bits from the plan's begin bit up
    (``lifted_key >> begin_bit``) gives the array the sort of the whole
    lifted key gives, and that the frame sorted; the bits below the begin
    bit are the index field and a zero gap."""
    _render(chain, "cpu", WIDE)
    d16 = chain in ("d16", "global", "local")
    for c in recorded:
        plan = c["plan"]
        assert (plan.d_lo == 0) == d16 and plan.lift > 0
        key = lifted_key(c["planes"], plan)
        begin = plan.sort_begin_bit
        assert begin == 32 - plan.d_lo and begin >= plan.idx_bits
        live = M.u32(c["planes"][0]) != SENTINEL
        low = key[live] & ((1 << begin) - 1)
        assert bool(torch.all(low < (1 << plan.idx_bits)))
        by_bits = key[torch.sort(key >> begin, stable=True).indices]
        whole = torch.sort(key).values
        assert torch.equal(by_bits, whole)
        assert torch.equal(c["sorted"], whole)


def test_stable_fallback_chain(recorded, monkeypatch):
    """With no KeyPlan the frame sorts stably (the permutation), and its
    ranges take the plain tile key (shift 0)."""
    monkeypatch.setattr(B, "make_key_plan", lambda *a, **k: None)
    _render("rows", "cpu")
    check_calls(recorded)
    assert [c["plan"] for c in recorded] == [None]


@pytest.mark.parametrize("keyplan", [True, False], ids=["keyplan", "stable"])
def test_counters_count_the_sort_path(keyplan, monkeypatch, recorded):
    """Sorts by path; no radix passes on the CPU, whose plain sort is
    ``torch.sort`` (CUB counts its passes on the card)."""
    if not keyplan:
        monkeypatch.setattr(B, "make_key_plan", lambda *a, **k: None)
    before = P.counters()
    _render("rows", "cpu")
    _render("stereo", "cpu")
    after = P.counters()
    assert after["frames"] - before["frames"] == 2
    assert after["sort_keys_only"] - before["sort_keys_only"] == 2 * keyplan
    assert after["sort_stable"] - before["sort_stable"] == 2 * (not keyplan)
    assert len(recorded) == 2
    assert after["sort_radix_passes"] == before["sort_radix_passes"]


# -- on the card ---------------------------------------------------------------

#: slot counts: below a warp, odd, one past a pack block (1024 slots), one
#: past a multiple of 4096, odd at a million, and the garden's 11M
CARD_SIZES = [1, 3, 31, 1025, 4097, 1_000_003, 11_010_048]


@pytest.mark.card
@pytest.mark.parametrize("n", CARD_SIZES)
def test_cuda_sort_is_torch_sort(card, n):
    """The pack, the keys-only sort and the ranges on the card against the
    pack's definition, torch.sort's values (the pairs sort) and today's
    ranges: bit-equal.  The planes are the two rows of one (2, n) tensor,
    as the expand writes them (key2 16-B aligned when n is a multiple of
    4)."""
    rng = np.random.default_rng(n)
    num_tiles, shift = 8160, 19  # the garden's 1080p grid: 13 tile bits
    k1, k2 = plan_keys(rng, n, num_tiles=num_tiles, shift=shift)
    planes = torch.stack([k1, k2]).cuda()
    packed = KS.sort_key_pack(planes[0], planes[1])
    assert torch.equal(packed, PC.sort_key64(planes[0], planes[1]))
    want = torch.sort(packed, stable=False).values
    got = KS.sort_keys_only(packed.clone())
    assert torch.equal(got, want)
    assert_ranges(KS.sort_ranges(got, num_tiles, shift),
                  yardstick_ranges(want, num_tiles, shift))


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_cuda_cases(card, name):
    """The key cases of the CPU tests on the card: the pack (with key1 one
    element off 16-B alignment, the kernel's slot-at-a-time path), the sort
    and the ranges, bit-equal to the plain versions."""
    num_tiles, shift, k1, k2 = _case(name)
    buf = torch.zeros(k1.shape[0] + 1, dtype=torch.int32, device="cuda")
    buf[1:] = k1.cuda()
    c1, c2 = buf[1:], k2.cuda()
    packed = KS.sort_key_pack_cuda(c1, c2)
    assert torch.equal(packed.cpu(), KS.sort_key64(k1, k2))
    got = KS.sort_keys_only_cuda(packed)
    want = KS.sort_keys_only_plain(KS.sort_key64(k1, k2))
    assert torch.equal(got.cpu(), want)
    assert_ranges(KS.sort_ranges_cuda(got, num_tiles, shift),
                  KS.sort_ranges_plain(want, num_tiles, shift))


def expand_order_planes(n, plan, num_tiles, *, device, seed=0, dead=0.06):
    """(key1, key2) int32 of ``n`` slots of ``plan`` in the expand's order:
    entries rise with the slot, each owning a run of about 4.6 consecutive
    slots (the garden's slots a visible gaussian), each slot in another
    tile; an entry's slots share its depth, and every seventh entry has one
    common depth (ties that only the index breaks); the last ``dead`` share
    of the slots is the sentinel (the capacity's tail)."""
    g = torch.Generator(device=device).manual_seed(seed)
    live = n - int(n * dead)
    entries = min(max(live * 10 // 46, 1), 1 << plan.idx_bits)
    slot = torch.arange(live, device=device)
    entry = slot * entries // live
    first = torch.searchsorted(entry, torch.arange(entries, device=device))
    base = torch.randint(0, num_tiles, (entries,), device=device, generator=g)
    tile = (base[entry] + slot - first[entry]) % num_tiles
    depth = torch.randint(0, plan.span + 1, (entries,), device=device,
                          generator=g)
    depth[::7] = plan.span // 3
    depth = depth[entry]
    k1 = (tile << plan.d_hi) | (depth >> plan.d_lo)
    k2 = ((depth & ((1 << plan.d_lo) - 1)) << plan.idx_bits) | entry
    planes = torch.full((2, n), SENTINEL, dtype=torch.int64, device=device)
    planes[0, :live], planes[1, :live] = k1, k2
    return M.to_i32(planes)


#: (plan, tiles) at the garden's shapes: the mono and side-by-side eye grid,
#: the foveated eye grid, a rows plan with 24 index bits (no gap), a d16 plan
GARDEN_PLANS = {
    "garden": (8160, 5_800_000, None),
    "foveated": (107 * 60, 5_800_000, None),
    "rows": (8160, 1 << 24, None),
    "d16": (8160, 5_800_000, 16),
}


def garden_plan(kind):
    num_tiles, n, span_bits = GARDEN_PLANS[kind]
    if span_bits:
        return B.make_key_plan(num_tiles, n, depth_span_bits=span_bits), \
            num_tiles
    return B.make_key_plan(num_tiles, n, near_plane=0.1,
                           far_plane=100.0), num_tiles


def test_expand_order_planes_hold_the_precondition():
    """The card tests' built keys: live slots of a tile in strictly rising
    entry index, ties in (tile, depth), and their begin-bit sort the
    whole-key sort (here on the CPU, by a stable torch.sort)."""
    plan, num_tiles = garden_plan("garden")
    planes = expand_order_planes(20_011, plan, num_tiles, device="cpu")
    key = PC.sort_key64(planes[0], planes[1], plan.lift, plan.idx_bits)
    begin = plan.sort_begin_bit
    hi = key >> begin
    by_bits = key[torch.sort(hi, stable=True).indices]
    assert torch.equal(by_bits, torch.sort(key).values)
    live = M.u32(planes[0]) != SENTINEL
    assert int(live.sum()) == 20_011 - int(20_011 * 0.06)
    assert torch.unique(hi[live]).numel() < int(live.sum())  # ties


@pytest.mark.card
@pytest.mark.parametrize("n", CARD_SIZES)
@pytest.mark.parametrize("kind", list(GARDEN_PLANS))
def test_cuda_begin_bit_sort_is_the_whole_key_sort(card, kind, n):
    """CUB from the plan's begin bit on keys in the expand's slot order,
    packed with the plan's lift, is bit-equal to torch.sort of the whole
    lifted key (and the pack to its plain version), on the two rows of one
    (2, n) tensor and with key1 one element off 16-B alignment."""
    plan, num_tiles = garden_plan(kind)
    planes = expand_order_planes(n, plan, num_tiles, device="cuda", seed=n)
    buf = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
    buf[1:] = planes[0]
    for k1 in (planes[0], buf[1:]):
        packed = KS.sort_key_pack(k1, planes[1], plan.lift, plan.idx_bits)
        assert torch.equal(packed, PC.sort_key64(k1, planes[1], plan.lift,
                                                 plan.idx_bits))
        want = torch.sort(packed).values
        got = KS.sort_keys_only(packed, plan.sort_begin_bit)
        assert torch.equal(got, want)
        assert_ranges(KS.sort_ranges(got, num_tiles, plan.d_hi),
                      yardstick_ranges(want, num_tiles, plan.d_hi))


@pytest.mark.card
@pytest.mark.parametrize("kind, passes", [("garden", 5), ("foveated", 5),
                                          ("rows", 5), ("d16", 4)])
def test_cuda_radix_passes(card, kind, passes):
    """At the garden's 11M slots CUB makes one pass per 8 bits it sorts: 5
    from the garden's begin bit 24, 4 from the d16 plan's 32, 8 over the
    whole key, read off the kernel and memset nodes of captured sorts
    (``measured_radix_passes``); ``radix_passes`` says as much."""
    plan, num_tiles = garden_plan(kind)
    planes = expand_order_planes(11_010_048, plan, num_tiles, device="cuda")
    packed = KS.sort_key_pack(planes[0], planes[1], plan.lift, plan.idx_bits)
    assert KS.radix_passes(plan.sort_begin_bit) == passes
    assert KS.measured_radix_passes(packed, plan.sort_begin_bit) == passes
    assert KS.measured_radix_passes(packed, 0) == 8 == KS.radix_passes(0)


@pytest.mark.card
@pytest.mark.parametrize("chain, passes", [("rows", 5), ("d16", 4)])
def test_cuda_radix_pass_counter(card, chain, passes, recorded):
    """``sort_radix_passes`` reads 5 a sort for a 1920x1080 DepthFirst
    frame (the garden's plan: tile 13 bits, depth_lo 8) and 4 for its
    BITS16 frame, the passes read off a captured sort of the frame's own
    keys."""
    _render(chain, "cuda", (1920, 1080))  # builds and loads the kernels
    recorded.clear()
    c0 = P.counters()
    _render(chain, "cuda", (1920, 1080))
    c1 = P.counters()
    sorts = c1["sort_keys_only"] - c0["sort_keys_only"]
    assert sorts == len(recorded) == 1
    assert c1["sort_radix_passes"] - c0["sort_radix_passes"] == passes * sorts
    plan = recorded[0]["plan"]
    assert plan.sort_begin_bit == 64 - 8 * passes
    key = lifted_key(recorded[0]["planes"], plan)
    assert KS.measured_radix_passes(key, plan.sort_begin_bit) == passes


@pytest.mark.card
@pytest.mark.parametrize("chain", CHAINS)
def test_cuda_chain_sort_and_ranges(card, chain, recorded):
    _render(chain, "cuda")
    check_calls(recorded)


@pytest.mark.card
@pytest.mark.parametrize("keyplan", [True, False], ids=["keyplan", "stable"])
def test_cuda_launches_once_a_frame(card, keyplan, monkeypatch):
    """Each frame launches the pack and the ranges once, and the keys-only
    sort once under a KeyPlan (the stable fallback keeps torch.sort)."""
    if not keyplan:
        monkeypatch.setattr(B, "make_key_plan", lambda *a, **k: None)
    _render("rows", "cuda")  # builds and loads the kernels
    before = [k.launches for k in (KS.PACK, KS.SORT, KS.RANGES)]
    for _ in range(3):
        _render("rows", "cuda")
    torch.cuda.synchronize()
    rise = [k.launches - b for k, b in zip((KS.PACK, KS.SORT, KS.RANGES),
                                           before)]
    assert rise == [3, 3 if keyplan else 0, 3]


@pytest.mark.card
@pytest.mark.parametrize("most", [0, 64, 1300])
def test_cuda_ranges_clamp_and_sum(card, most):
    """The ranges' counts pass at the garden's shapes (11M slots, 8,160
    tiles, about 1,350 slots a tile): each count clamped to ``most`` where
    it is above 0 (the Local frames' clamp; 1,300 binds on some tiles
    only) and their sum beside them, bit-equal to the plain version's
    clamp and torch sum."""
    rng = np.random.default_rng(most)
    num_tiles, shift = 8160, 19
    k1, k2 = plan_keys(rng, 11_010_048, num_tiles=num_tiles, shift=shift)
    got = KS.sort_keys_only(KS.sort_key_pack(k1.cuda(), k2.cuda()))
    ranges = KS.sort_ranges_cuda(got, num_tiles, shift, most)
    want = KS.sort_ranges_plain(got, num_tiles, shift, most)
    assert_ranges(ranges, want)
    assert ranges[2].shape == () and int(ranges[2]) == int(ranges[1].sum())
    if most:
        assert int(ranges[1].max()) == most
        assert int(ranges[1].min()) < most or most == 64


#: prep's modes on the card: those of the CPU file, and the band clamp
CARD_PREP_MODES = [*MODES, "band"]


def _prep(mode, tensors, plain=False):
    """The CUDA prep of ``mode`` on the built tensors moved to the card, or
    with ``plain`` the plain version on the same tensors there."""
    if mode == "band":
        planes = [t.cuda() for t in tensors]
        fn = KE.binning_prep_band_plain if plain else KE.binning_prep_band_cuda
        return fn(*planes, band0=20, band1=40)
    rect_word, rect_h, words = tensors
    kw = dict(MODES[mode])
    if mode == "warped":
        kw["warped_bounds"] = warped_bounds().cuda()
    if mode in ("mono_rows", "mono_full", "none"):
        words = words[:4]
    fn = KE.binning_prep_plain if plain else KE.binning_prep_cuda
    return fn(rect_word.cuda(), rect_h.cuda(), [w.cuda() for w in words],
              **kw)


def _built_tensors(mode, n):
    if mode == "band":
        return [i32(a) for a in band_planes(n, "mixed")[:4]]
    rect_word, rect_h, _culled, rows = built_inputs(n, "mixed")
    return i32(rect_word), i32(rect_h), [i32(w) for w in rows]


@pytest.mark.card
@pytest.mark.parametrize("n", [1_000_003, 5_800_000])
@pytest.mark.parametrize("mode", CARD_PREP_MODES)
def test_cuda_prep_sums_are_plain(card, mode, n):
    """The CUDA prep's header sums, and its tables, equal the plain prep's
    on the card bit for bit; launches of other sizes between two at ``n``
    leave the record the same."""
    tensors = _built_tensors(mode, n)
    got = _prep(mode, tensors)
    want = _prep(mode, tensors, plain=True)
    for k, (g, w) in enumerate(zip(got, want, strict=True)):
        assert (g is None) == (w is None), f"output {k}"
        if w is not None:
            assert torch.equal(g, w), f"output {k}"
    assert got[-1].dtype == torch.int32 and got[-1].shape == (3,)
    for m in (257, 1):
        _prep(mode, _built_tensors(mode, m))
    again = _prep(mode, tensors)
    assert torch.equal(again[-1], got[-1])
