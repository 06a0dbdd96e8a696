"""Blend parity: gsm_renderer_tpu_torch's plain blend vs the JAX package's
``blend_tiles_pallas`` (interpret mode) and ``blend_tiles_xla``.

Both sides get the same sorted record words, starts and counts, made from a
seed with numpy.  Early-exit rule under test (the port's, shared by its CUDA
kernel and its plain version): 256-record batches aligned to 128-record
blocks, the tile stops after a batch once every pixel's transmittance is
below 1/255 -- the Pallas kernel's chunking, so the two stop at the same
record; the XLA blend never stops.

Tolerances: colour and alpha within 5e-3 of both (the 1/255 early-exit
bound); depth within 5e-2 of both (the residual transmittance < 1/255 times
depths up to 12 in the heavy scene, plus float32 summation order).

The port reads records through the sorted keys (entry index = the key's low
``idx_bits`` bits); the JAX package's sorted table goes in through the
identity key, ``arange(C)`` with ``idx_bits = 32``.  One more test holds the
plain blend through permuted keys and an entry table bit-equal to the plain
blend of the same records gathered into sorted order (mono, stereo, pixel
coordinates).

Depth mode "first_hit" (the Local renderer's) and 32x16 tiles (the Global
renderer's) against the Pallas kernel: colour and alpha within COLOR_TOL,
weighted depth within DEPTH_TOL; the first-hit depth equals the Pallas
kernel's at every pixel but those whose first alpha > 0.1 record differs
(an alpha within float noise of 0.1: XLA and PyTorch exp / log differ by an
ulp), counted and capped at 0.5% of the pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsm_renderer_tpu.kernels import blend as JK

from gsm_renderer_tpu_torch.kernels import blend as TK

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

COLOR_TOL = 5e-3
DEPTH_TOL = 5e-2


def f16b(x):
    return np.asarray(x, np.float16).view(np.uint16).astype(np.uint32)


def synth(rng, tiles_x, tiles_y, per_tile, sigma=(0.6, 12.0), op=(1, 256),
          depth=(0.1, 50.0), tile_w=16):
    """Quantized records for ``per_tile`` instances in each tile (a few tiles
    empty or short, dead zero slots after the last span), with the XLA
    oracle's attribute table built from the decoded values."""
    n_t = tiles_x * tiles_y
    n_live = n_t * per_tile
    cap = -(-(n_live + 300) // 128) * 128
    mx = rng.uniform(0, tiles_x * tile_w, n_live).astype(np.float32)
    my = rng.uniform(0, tiles_y * 16, n_live).astype(np.float32)
    s1 = rng.uniform(*sigma, n_live).astype(np.float32)
    s2 = rng.uniform(*sigma, n_live).astype(np.float32)
    th = rng.uniform(0, np.pi, n_live).astype(np.float32)
    opq = rng.integers(op[0], op[1], n_live).astype(np.uint32)
    col = rng.integers(0, 256, (n_live, 3)).astype(np.uint32)
    dep = rng.uniform(*depth, n_live).astype(np.float32)
    w = [np.zeros(cap, np.uint32) for _ in range(4)]
    w[0][:n_live] = f16b(mx) | (f16b(my) << 16)
    w[1][:n_live] = np.round(th / np.pi * 65535.0).astype(np.uint32) | (f16b(s1) << 16)
    w[2][:n_live] = f16b(s2) | (f16b(dep) << 16)
    w[3][:n_live] = col[:, 0] | (col[:, 1] << 8) | (col[:, 2] << 16) | (opq << 24)
    starts = (np.arange(n_t) * per_tile).astype(np.int32)
    counts = np.full(n_t, per_tile, np.int32)
    counts[min(3, n_t - 1)] = 0
    counts[min(1, n_t - 1)] = max(per_tile - 7, 0)

    def deco(bits):
        return np.asarray(bits, np.uint16).view(np.float16).astype(np.float32)

    s1d = np.maximum(deco(w[1] >> 16), 1e-4)
    s2d = np.maximum(deco(w[2] & 0xFFFF), 1e-4)
    thd = (w[1] & 0xFFFF).astype(np.float32) * np.float32(np.pi / 65535.0)
    c, s = np.cos(thd), np.sin(thd)
    mxd, myd = deco(w[0] & 0xFFFF), deco(w[0] >> 16)
    a1, b1, a2, b2 = c / s1d, s / s1d, -s / s2d, c / s2d
    attrs = dict(a1=a1, b1=b1, c1=-(a1 * mxd + b1 * myd), a2=a2, b2=b2,
                 c2=-(a2 * mxd + b2 * myd), r=(w[3] & 0xFF) / 255.0,
                 g=((w[3] >> 8) & 0xFF) / 255.0, b=((w[3] >> 16) & 0xFF) / 255.0,
                 depth=deco(w[2] >> 16), op=((w[3] >> 24) & 0xFF) / 255.0)
    attr_table = JK.build_blend_table(
        {k: jnp.asarray(v.astype(np.float32)) for k, v in attrs.items()}, cap)
    words_table = JK.build_words_table([jnp.asarray(x) for x in w], cap)
    port_table = torch.from_numpy(np.stack(w).view(np.int32).copy())
    return dict(attr=attr_table, words=words_table, port=port_table,
                starts=starts, counts=counts, per=max(per_tile, 1))


@pytest.fixture(scope="module", params=["light", "heavy"])
def case(request):
    rng = np.random.default_rng(21)
    if request.param == "light":
        # ~37 records per tile: no tile saturates
        d = synth(rng, 6, 4, 37)
        tiles_x, tiles_y = 6, 4
    else:
        # 700 large, opaque records per tile: tiles saturate mid-span, so
        # the early exit decides the result
        d = synth(rng, 2, 2, 700, sigma=(6.0, 24.0), op=(180, 256),
                  depth=(1.0, 12.0))
        tiles_x, tiles_y = 2, 2
    starts, counts = jnp.asarray(d["starts"]), jnp.asarray(d["counts"])
    pal = JK.blend_tiles_pallas(d["words"], starts, counts, tiles_x=tiles_x,
                                tiles_y=tiles_y, interpret=True)
    xla = JK.blend_tiles_xla(d["attr"], starts, counts, tiles_x=tiles_x,
                             tiles_y=tiles_y, max_per_tile=d["per"])
    d.update(tiles_x=tiles_x, tiles_y=tiles_y, name=request.param,
             pallas=[np.asarray(x) for x in pal], xla=[np.asarray(x) for x in xla])
    return d


def identity_key(cap):
    return torch.arange(cap, dtype=torch.int64)


def port_blend(d, **kw):
    return TK.blend_tiles_plain(identity_key(d["port"].shape[1]), d["port"], 32,
                                torch.from_numpy(d["starts"]),
                                torch.from_numpy(d["counts"]),
                                tiles_x=d["tiles_x"], **kw)


def test_blend_matches_pallas_and_xla(case):
    color, depth, processed = port_blend(case, return_processed=True)
    for ref_color, ref_depth in (case["pallas"], case["xla"]):
        np.testing.assert_allclose(color.numpy(), ref_color, atol=COLOR_TOL)
        np.testing.assert_allclose(depth.numpy(), ref_depth, atol=DEPTH_TOL)
    counts = torch.from_numpy(case["counts"])
    if case["name"] == "heavy":
        live = counts > 0
        assert (processed[live] < counts[live]).all()   # every tile exited early
        # same exit point as the Pallas kernel: float32-close, not 1/255-close
        np.testing.assert_allclose(color.numpy(), case["pallas"][0], atol=1e-5)
        assert (color[live][..., 3] > 1.0 - 1.0 / 255.0).all()
    else:
        assert (processed == counts).all()
    assert float(color[..., :3].max()) > 0.05


@pytest.mark.parametrize("depth_mode,tile_w", [("first_hit", 16),
                                               ("weighted", 32),
                                               ("first_hit", 32)])
def test_blend_modes_match_pallas(depth_mode, tile_w):
    rng = np.random.default_rng(27)
    tiles_x, tiles_y = 3, 2
    # half the tiles saturate mid-span: the early exit and late hits count
    d = synth(rng, tiles_x, tiles_y, 300, sigma=(1.0, 16.0), op=(20, 256),
              depth=(1.0, 12.0), tile_w=tile_w)
    starts, counts = jnp.asarray(d["starts"]), jnp.asarray(d["counts"])
    ref_color, ref_depth = (np.asarray(x) for x in JK.blend_tiles_pallas(
        d["words"], starts, counts, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_w=tile_w, depth_mode=depth_mode, interpret=True))
    color, depth = port_blend(dict(d, tiles_x=tiles_x), tile_w=tile_w,
                              depth_mode=depth_mode)
    assert color.shape == (tiles_x * tiles_y, tile_w * 16, 4)
    np.testing.assert_allclose(color.numpy(), ref_color, atol=COLOR_TOL)
    if depth_mode == "weighted":
        np.testing.assert_allclose(depth.numpy(), ref_depth, atol=DEPTH_TOL)
    else:
        flips = depth.numpy() != ref_depth
        assert flips.sum() <= 0.005 * depth.numel(), f"{flips.sum()} flips"
        assert (depth.numpy() > 0).mean() > 0.5  # most pixels hit
        assert (depth.numpy() == 0).any() or (counts == 0).any()
    assert float(color[..., :3].max()) > 0.05


def test_blend_first_hit_semantics():
    """First-hit depth on hand-made records: the first record with alpha >
    0.1 sets the depth even when later ones are more opaque; a faint first
    record (alpha <= 0.1) is skipped; no hit gives 0; the colour equals the
    weighted blend's."""
    def rec(mx, my, s, op, d):
        return [int(f16b(mx) | (f16b(my) << 16)), int(f16b(s) << 16),
                int(f16b(s) | (f16b(d) << 16)), int(0x808080 | (op << 24))]

    # pixel (8, 8) of tile 0: records at its centre; tile 1 gets a faint one
    recs = [rec(8, 8, 6.0, 20, 3.0),     # alpha ~ 0.078: no hit
            rec(8, 8, 6.0, 100, 5.0),    # alpha ~ 0.39: the first hit
            rec(8, 8, 6.0, 250, 7.0),    # more opaque, later
            rec(24, 8, 6.0, 20, 9.0)]    # tile 1: faint only
    table = torch.tensor(np.array(recs, np.int64).T.astype(np.uint32).view(np.int32))
    starts, counts = torch.tensor([0, 3], dtype=torch.int32), torch.tensor(
        [3, 1], dtype=torch.int32)
    kw = dict(tiles_x=2)
    c_fh, d_fh = TK.blend_tiles_plain(identity_key(4), table, 32, starts,
                                      counts, depth_mode="first_hit", **kw)
    c_w, _ = TK.blend_tiles_plain(identity_key(4), table, 32, starts, counts,
                                  **kw)
    assert torch.equal(c_fh, c_w)
    p = 8 * 16 + 8
    assert float(d_fh[0, p]) == 5.0
    assert float(d_fh[1, p]) == 0.0


def test_blend_no_depth(case):
    color, depth = port_blend(case)
    color_nd, depth_nd = port_blend(case, depth_mode="none")
    assert depth_nd is None and depth is not None
    np.testing.assert_array_equal(color_nd.numpy(), color.numpy())


def test_blend_tile_subset_and_assembly(case):
    """A subset of tiles blends exactly as in the full call, and assembly
    crops the ragged edge in row-major tile order."""
    color, depth = port_blend(case)
    sub = torch.tensor([case["tiles_x"] * case["tiles_y"] - 1, 0])
    c_sub, d_sub = port_blend(case, tiles=sub)
    np.testing.assert_array_equal(c_sub.numpy(), color[sub].numpy())
    w, h = case["tiles_x"] * 16 - 5, case["tiles_y"] * 16 - 3
    img, dimg = TK.assemble_image(color, depth, tiles_x=case["tiles_x"],
                                  tiles_y=case["tiles_y"], width=w, height=h)
    assert img.shape == (h, w, 4) and dimg.shape == (h, w)
    t = case["tiles_x"] + 1 if case["tiles_y"] > 1 else 0
    ty, tx = divmod(t, case["tiles_x"])
    np.testing.assert_array_equal(img[ty * 16 + 2, tx * 16 + 3].numpy(),
                                  color[t, 2 * 16 + 3].numpy())


def entry_records(rng, n, n_eyes, extent):
    """4 * n_eyes (n,) int32 word rows of random quantized records whose
    means lie within ``extent`` = (width, height) pixels."""
    rows = []
    for _ in range(n_eyes):
        mx = rng.uniform(0, extent[0], n).astype(np.float32)
        my = rng.uniform(0, extent[1], n).astype(np.float32)
        s1 = rng.uniform(0.6, 12.0, n).astype(np.float32)
        s2 = rng.uniform(0.6, 12.0, n).astype(np.float32)
        th = rng.integers(0, 65536, n).astype(np.uint32)
        col = rng.integers(0, 256, (n, 4)).astype(np.uint32)
        rows += [f16b(mx) | (f16b(my) << 16), th | (f16b(s1) << 16),
                 f16b(s2) | (f16b(rng.uniform(0.1, 50.0, n)) << 16),
                 col[:, 0] | (col[:, 1] << 8) | (col[:, 2] << 16) | (col[:, 3] << 24)]
    return torch.from_numpy(np.stack(rows).view(np.int32).copy())


@pytest.mark.parametrize("mode", ["mono", "stereo", "pixel_coords"])
def test_blend_through_keys_equals_gathered_table(mode):
    """The plain blend reading entry g = key & (2**idx_bits - 1) of each
    sorted rank is bit-equal to the plain blend of the same records gathered
    into sorted order and read through the identity key."""
    rng = np.random.default_rng({"mono": 1, "stereo": 2, "pixel_coords": 3}[mode])
    tiles_x, tiles_y, n_ent, idx_bits = 3, 2, 300, 9
    n_eyes = 1 if mode == "mono" else 2
    words = entry_records(rng, n_ent, n_eyes, (tiles_x * 16, tiles_y * 16))
    counts = rng.integers(60, 330, tiles_x * tiles_y).astype(np.int32)
    counts[2] = 0
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    n_live = int(counts.sum())
    cap = n_live + 200
    entry = rng.integers(0, n_ent, n_live)
    # a depth field above the index bits, a tile field in the high word,
    # and sentinel keys on the dead slots after the spans
    key2 = (rng.integers(0, 1 << (32 - idx_bits), n_live) << idx_bits) | entry
    key1 = rng.integers(0, 1 << 20, n_live)
    sorted_key = np.full(cap, (0x7FFFFFFF << 32) | 0xFFFFFFFF, np.int64)
    sorted_key[:n_live] = (key1 << 32) | key2
    table = torch.zeros((4 * n_eyes, cap), dtype=torch.int32)
    table[:, :n_live] = words[:, torch.from_numpy(entry)]
    kw = dict(tiles_x=tiles_x, n_eyes=n_eyes, return_processed=True)
    if mode != "mono":
        kw["r2_cutoff"] = 9.0
    if mode == "pixel_coords":
        base = np.arange(16, dtype=np.float32)
        cx = (np.arange(tiles_x)[:, None] * 16.0 + np.tile(base, 16)[None, :]
              + rng.uniform(-3.0, 3.0, (tiles_x, 256)))
        cy = (np.arange(tiles_y)[:, None] * 16.0 + np.repeat(base, 16)[None, :]
              + rng.uniform(-3.0, 3.0, (tiles_y, 256)))
        kw["pixel_coords"] = (torch.from_numpy(cx.astype(np.float32)),
                              torch.from_numpy(cy.astype(np.float32)))
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    keyed = TK.blend_tiles_plain(torch.from_numpy(sorted_key), words, idx_bits,
                                 st, ct, **kw)
    gathered = TK.blend_tiles_plain(identity_key(cap), table, 32, st, ct, **kw)
    if n_eyes == 1:  # (color, depth, processed)
        keyed, gathered = ([keyed[:2]], keyed[2]), ([gathered[:2]], gathered[2])
    assert torch.equal(keyed[1], gathered[1])  # records composited
    for (kc, kd), (gc, gd) in zip(keyed[0], gathered[0], strict=True):
        assert torch.equal(kc, gc) and torch.equal(kd, gd)
        assert float(kc[..., :3].max()) > 0.05
