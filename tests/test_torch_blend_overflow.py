"""Blend parity on records whose f16 fields overflowed: the port's plain
blend against the JAX package's ``blend_tiles_pallas`` (interpret mode).

The projection packs a mean or a scale past f16's range as the bits of
+-inf (and NaN as 0x7E00).  Both decodes read exponent 31 as the finite
2^16 (1 + m / 1024), so such a record is an ordinary, far-away gaussian: no
pixel goes NaN, and the CUDA blend's record culling may skip it where its
reach ends (csrc/blend.cu, reach_mask; chip_smoke.py's
overflow_records_check holds the kernel to the plain version on such
records on the card).  Each tile of a 8x1-tile frame holds 40 ordinary
records and, at rank 5, one record of one kind below (means at theta 0,
where a linear form has a zero coefficient, and not; scales), blended one
eye without a cutoff and two eyes with r2 9.  Tolerance: 1e-5 on colour
and alpha, 1e-4 on depth (depths up to 40): XLA's and PyTorch's exp and
log differ by an ulp (colour within 3e-7, depth within 1.2e-5 seen).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsm_renderer_tpu.kernels import blend as JK

from gsm_renderer_tpu_torch.kernels import blend as TK

torch.set_num_threads(1)

COLOR_TOL = 1e-5
DEPTH_TOL = 1e-4
PER = 40
#: (label, word, bit shift, f16 bits, theta 0) of each tile's planted record
KINDS = (("mx_inf_theta0", 0, 0, 0x7C00, True),
         ("mx_neg_inf_theta0", 0, 0, 0xFC00, True),
         ("my_inf_theta0", 0, 16, 0x7C00, True),
         ("my_nan_theta0", 0, 16, 0x7E00, True),
         ("mx_inf", 0, 0, 0x7C00, False),
         ("my_neg_inf", 0, 16, 0xFC00, False),
         ("s1_inf", 1, 16, 0x7C00, False),
         ("s2_nan", 2, 0, 0x7E00, False))
MODES = {"mono": (1, 0.0), "stereo_r2_9": (2, 9.0)}


def f16b(x):
    return np.asarray(x, np.float16).view(np.uint16).astype(np.uint32)


def planted_words():
    """(4 word rows (cap,) uint32, starts, counts): tile t's records at
    [PER * t, PER * (t + 1)), its KINDS[t] record at rank PER * t + 5."""
    rng = np.random.default_rng(3)
    n_t = len(KINDS)
    n = n_t * PER
    cap = -(-(n + 300) // 128) * 128
    mx = rng.uniform(0, 16, n) + np.repeat(np.arange(n_t) * 16, PER)
    my = rng.uniform(0, 16, n)
    w = [np.zeros(cap, np.uint32) for _ in range(4)]
    w[0][:n] = f16b(mx) | f16b(my) << 16
    w[1][:n] = rng.integers(1, 65535, n).astype(np.uint32) | \
        f16b(rng.uniform(1, 6, n)) << 16
    w[2][:n] = f16b(rng.uniform(1, 6, n)) | f16b(rng.uniform(1, 40, n)) << 16
    w[3][:n] = rng.integers(0, 1 << 24, n).astype(np.uint32) | \
        rng.integers(30, 256, n).astype(np.uint32) << 24
    for t, (_label, word, shift, bits, theta0) in enumerate(KINDS):
        i = PER * t + 5
        w[word][i] = (w[word][i] & ~np.uint32(0xFFFF << shift)) | \
            np.uint32(bits << shift)
        if theta0:
            w[1][i] &= np.uint32(0xFFFF0000)
    starts = (np.arange(n_t) * PER).astype(np.int32)
    return w, starts, np.full(n_t, PER, np.int32)


@pytest.fixture(scope="module")
def blends():
    """Per mode: (the JAX Pallas kernel's, the port's plain) per-eye lists
    of (tile colour (T, 256, 4), tile depth (T, 256)) numpy arrays."""
    w, starts, counts = planted_words()
    n_t = len(KINDS)
    out = {}
    for name, (eyes, r2) in MODES.items():
        rows = w * eyes
        pal = JK.blend_tiles_pallas(
            JK.build_words_table([jnp.asarray(x) for x in rows], w[0].size),
            jnp.asarray(starts), jnp.asarray(counts), tiles_x=n_t, tiles_y=1,
            n_eyes=eyes, r2_cutoff=r2, interpret=True)
        port = TK.blend_tiles_plain(
            torch.arange(w[0].size, dtype=torch.int64),
            torch.from_numpy(np.stack(rows).view(np.int32).copy()), 32,
            torch.from_numpy(starts), torch.from_numpy(counts), tiles_x=n_t,
            n_eyes=eyes, r2_cutoff=r2)
        if eyes == 1:
            pal, port = [pal], [port]
        out[name] = ([tuple(np.asarray(x) for x in e) for e in pal],
                     [tuple(x.numpy() for x in e) for e in port])
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", range(len(KINDS)),
                         ids=[k[0] for k in KINDS])
def test_overflowed_record_blends_as_the_reference(blends, mode, kind):
    """The tile holding the planted record: the port's plain blend equals
    the Pallas kernel's within COLOR_TOL and DEPTH_TOL in every eye, and
    is finite."""
    ref, port = blends[mode]
    for (rc, rd), (pc, pd) in zip(ref, port):
        assert np.isfinite(pc[kind]).all() and np.isfinite(pd[kind]).all()
        np.testing.assert_allclose(pc[kind], rc[kind], atol=COLOR_TOL, rtol=0)
        np.testing.assert_allclose(pd[kind], rd[kind], atol=DEPTH_TOL, rtol=0)
        assert float(pc[kind][..., 3].max()) > 0.1  # the tile is drawn
