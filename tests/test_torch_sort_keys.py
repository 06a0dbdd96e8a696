"""The keys-only instance sort (``kernels/sort.py``): the key pack, the
keys-only radix sort and the tile ranges.

On the CPU: the plain pack (``sort_key64``) against the key's definition
computed in numpy, and the plain ranges (``binning_sorted_tile`` +
``ops.binning.extract_tile_ranges``, torch.searchsorted) against a count of
each tile's keys in numpy, on built keys (key1 with bit 31 set and clear,
the sentinel, empty leading, middle and trailing tiles, all slots dead, one
slot, a band grid, shift 0, tile ids at and past the tile count); every
frame chain's sort and ranges (DepthFirst with rows and with
16-bit depth keys, Global, Local, Hardware, stereo, foveated, the band
chain, the stable fallback) against those yardsticks and
``torch.sort(sort_key64(...)).values``; the counters of the sort paths.

On the card (marked ``card``): the CUDA pack, CUB's keys-only sort and the
ranges kernels bit-equal to the same yardsticks at sizes that are not a
multiple of a block, with planes that are not 16-B aligned and at 11M
slots; the ranges' clamped counts and their sum (the header's
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


def numpy_key(key1, key2):
    """The pack's definition: (u32(key1) ^ 2**31) in the high word, u32(key2)
    in the low, read as int64."""
    hi = (key1.numpy().view(np.uint32) ^ np.uint32(1 << 31)).astype(np.uint64)
    lo = key2.numpy().view(np.uint32).astype(np.uint64)
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
    assert torch.equal(got, torch.sort(PC.sort_key64(k1, k2)).values)
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


def _band_chain(gi, cam, band0=1, band1=3):
    """One band rank's chain (parallel/multichip.py): the projection block,
    prep "band", the expand at the band's tile row offset, then
    sort_and_ranges over the tiles_x x bands grid."""
    tiles_x = -(-W // 16)
    block = MC.project_block(
        gi, cam.view_matrix, cam.projection_matrix, cam.position, width=W,
        height=H, tile_w=16, tile_h=16, sh_degree=1,
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


def _render(chain, device):
    gi, cam = _scene(device), T.make_camera(W, H, far=20.0)
    config = dict(sh_degree=1, max_width=W, max_height=H)
    if chain == "band":
        return _band_chain(gi, cam)
    cls = {"global": T.GlobalRenderer, "local": T.LocalRenderer,
           "hardware": T.HardwareRenderer}.get(chain, T.DepthFirstRenderer)
    if chain == "d16":
        config["depth_sort_key_precision"] = T.DepthSortKeyPrecision.BITS16
    r = cls(T.RendererConfig(**config), device=device)
    stereo = T.make_side_by_side_stereo(cam)
    if chain == "stereo":
        return r.render_stereo(gi, stereo, W, H)
    if chain == "foveated":
        return r.render_stereo_foveated(
            gi, stereo, T.make_rate_maps(W, H, min_rate=0.4, radius=0.3))
    return r.render(gi, cam, W, H)


CHAINS = ["rows", "d16", "global", "local", "hardware", "stereo", "foveated",
          "band"]


def check_calls(calls):
    assert calls
    for c in calls:
        plan = c["plan"]
        k1, k2 = c["planes"][:2]
        want = torch.sort(PC.sort_key64(k1, k2), stable=plan is None).values
        assert torch.equal(c["sorted"], want)
        shift = 0 if plan is None else plan.d_hi
        assert_ranges(c["ranges"],
                      yardstick_ranges(c["sorted"], c["num_tiles"], shift))


@pytest.mark.parametrize("chain", CHAINS)
def test_chain_sort_and_ranges(chain, recorded):
    _render(chain, "cpu")
    check_calls(recorded)
    assert all(c["plan"] is not None for c in recorded)


def test_stable_fallback_chain(recorded, monkeypatch):
    """With no KeyPlan the frame sorts stably (the permutation), and its
    ranges take the plain tile key (shift 0)."""
    monkeypatch.setattr(B, "make_key_plan", lambda *a, **k: None)
    _render("rows", "cpu")
    check_calls(recorded)
    assert [c["plan"] for c in recorded] == [None]


@pytest.mark.parametrize("keyplan", [True, False], ids=["keyplan", "stable"])
def test_counters_count_the_sort_path(keyplan, monkeypatch):
    if not keyplan:
        monkeypatch.setattr(B, "make_key_plan", lambda *a, **k: None)
    before = P.counters()
    _render("rows", "cpu")
    _render("stereo", "cpu")
    after = P.counters()
    assert after["frames"] - before["frames"] == 2
    assert after["sort_keys_only"] - before["sort_keys_only"] == 2 * keyplan
    assert after["sort_stable"] - before["sort_stable"] == 2 * (not keyplan)


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
