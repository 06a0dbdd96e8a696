"""The two-sort helpers of gsm_renderer_tpu_torch.ops.binning
(``unpack_rect_word``, ``depth_order``, ``SlotMap`` / ``build_slot_map``,
``slot_tile_ids``, ``stable_sort_by_tile``, ``gather_sorted_records``)
against gsm_renderer_tpu.ops.binning on the same seeded numpy inputs.
Every output is an integer (or a boolean): all are equal.  Keys are u32
in JAX and int64 holding the u32 value in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsm_renderer_tpu.ops import binning as JB

from gsm_renderer_tpu_torch.ops import binning as TB

torch.set_num_threads(1)

SENTINEL = 0xFFFFFFFF
TILES_X, TILES_Y = 24, 17


def u32_np(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def as_i32(words):
    """u32 numpy words -> the port's int32 bit-holding tensor."""
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy())


def scene(seed, n=700):
    """Rects inside the tile grid, counts rect_w * rect_h (some culled to
    0), depth keys with ties and culled sentinels."""
    r = np.random.default_rng(seed)
    rect_w = r.integers(1, 6, n)
    rect_h = r.integers(1, 5, n)
    min_tx = r.integers(0, TILES_X - rect_w + 1)
    min_ty = r.integers(0, TILES_Y - rect_h + 1)
    word = (min_tx | (min_ty << 10) | (rect_w << 20)).astype(np.uint32)
    culled = r.random(n) < 0.1
    counts = np.where(culled, 0, rect_w * rect_h).astype(np.int32)
    depth = r.integers(0x3F000000, 0x3F000000 + 300, n).astype(np.uint32)
    depth[culled] = SENTINEL
    return word, counts, depth


def test_unpack_rect_word_matches_jax():
    words = np.random.default_rng(1).integers(0, 1 << 32, 4096,
                                              dtype=np.uint64).astype(np.uint32)
    want = JB.unpack_rect_word(jnp.asarray(words))
    for src in (as_i32(words), torch.from_numpy(u32_np(words))):
        got = TB.unpack_rect_word(src)
        for w, g in zip(want, got, strict=True):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [2, 3])
def test_depth_order_matches_jax(seed):
    _word, _counts, depth = scene(seed)
    jk, jo = JB.depth_order(jnp.asarray(depth))
    tk, to = TB.depth_order(as_i32(depth))
    np.testing.assert_array_equal(tk.numpy(), u32_np(jk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.dtype == torch.int32
    # the keys tie: the order is the stable one
    assert len(np.unique(depth)) < depth.shape[0] // 2


@pytest.mark.parametrize("capacity", [256, 2048, 8192])
def test_build_slot_map_matches_jax(capacity):
    """Below, near and above the slot total (overflow 1, 1, 0); counts of
    0 lie between the others and at the start."""
    _word, counts, _depth = scene(4)
    counts[:3] = 0
    want = JB.build_slot_map(jnp.asarray(counts), capacity)
    got = TB.build_slot_map(torch.from_numpy(counts), capacity)
    for name in ("rank", "j", "slot_valid", "total", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.overflow) == int(int(counts.sum()) > capacity)


@pytest.mark.parametrize("capacity", [2048, 8192])
def test_slot_tile_ids_matches_jax(capacity):
    word, counts, _depth = scene(5)
    jm = JB.build_slot_map(jnp.asarray(counts), capacity)
    tm = TB.build_slot_map(torch.from_numpy(counts), capacity)
    want = JB.slot_tile_ids(jm, jnp.asarray(word), TILES_X)
    got = TB.slot_tile_ids(tm, as_i32(word), TILES_X)
    np.testing.assert_array_equal(got.numpy(), u32_np(want))
    assert (got.numpy() != SENTINEL).sum() == min(int(counts.sum()), capacity)


def test_stable_sort_by_tile_and_gather_match_jax():
    r = np.random.default_rng(6)
    c = 5000
    tile = r.integers(0, 40, c).astype(np.uint32)
    tile[r.random(c) < 0.2] = SENTINEL
    payload = r.permutation(c).astype(np.int32)
    payload[:7] = -1
    jk, jp = JB.stable_sort_by_tile(jnp.asarray(tile), jnp.asarray(payload))
    tk, tp = TB.stable_sort_by_tile(torch.from_numpy(u32_np(tile)),
                                    torch.from_numpy(payload))
    np.testing.assert_array_equal(tk.numpy(), u32_np(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    records = r.integers(0, 1 << 32, (c, 4), dtype=np.uint64).astype(np.uint32)
    want = JB.gather_sorted_records(jp, jnp.asarray(records))
    got = TB.gather_sorted_records(tp, as_i32(records))
    np.testing.assert_array_equal(u32_np(got.numpy().view(np.uint32)),
                                  u32_np(want))


@pytest.mark.parametrize("seed", [7, 8])
def test_two_sort_chain_matches_jax_and_the_keyplan_order(seed):
    """depth_order -> counts in depth order -> build_slot_map ->
    slot_tile_ids -> stable_sort_by_tile -> extract_tile_ranges, in both
    packages: equal at every step, and the sorted (tile, gaussian) pairs
    are the KeyPlan order of the same instances (the order the frames
    sort into)."""
    word, counts, depth = scene(seed)
    cap = 8192
    _jk, jo = JB.depth_order(jnp.asarray(depth))
    _tk, to = TB.depth_order(as_i32(depth))
    jo_np = np.asarray(jo)
    jm = JB.build_slot_map(jnp.asarray(counts[jo_np]), cap)
    tm = TB.build_slot_map(torch.from_numpy(counts)[to.to(torch.int64)], cap)
    jt = JB.slot_tile_ids(jm, jnp.asarray(word[jo_np]), TILES_X)
    tt = TB.slot_tile_ids(tm, as_i32(word)[to.to(torch.int64)], TILES_X)
    np.testing.assert_array_equal(tt.numpy(), u32_np(jt))
    j_gauss = jnp.where(jm.slot_valid, jo[jm.rank], -1)
    t_gauss = torch.where(tm.slot_valid, to[tm.rank.to(torch.int64)], -1)
    jsk, jsp = JB.stable_sort_by_tile(jt, j_gauss)
    tsk, tsp = TB.stable_sort_by_tile(tt, t_gauss)
    np.testing.assert_array_equal(tsk.numpy(), u32_np(jsk))
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
    js, jc = JB.extract_tile_ranges(jsk, TILES_X * TILES_Y)
    ts, tc = TB.extract_tile_ranges(tsk, TILES_X * TILES_Y)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    # the KeyPlan order: (tile, depth word, gaussian index), strictly
    # increasing (each gaussian holds one slot a tile)
    live = tsk.numpy() != SENTINEL
    tiles, gauss = tsk.numpy()[live], tsp.numpy()[live]
    order = np.lexsort((gauss, depth[gauss], tiles))
    np.testing.assert_array_equal(order, np.arange(order.shape[0]))
    assert len(set(zip(tiles.tolist(), gauss.tolist()))) == tiles.shape[0]
