"""gsm_renderer_tpu_torch.ops.project (``project_and_cull``,
``derive_blend_attributes``, ``stereo_project_and_cull``) and the packed
world-gaussian codecs of gsm_renderer_tpu_torch.types against the JAX
package, on the same seeded scenes.

Tolerances (the ROADMAP parity contract):
* projection: ``visible``, the tile rect, ``rect_count``, ``depth_key``
  and the quantized record (f16 mean, sigmas and depth bits; u8 colour and
  opacity) equal, except at gaussians of float-boundary flips -- PyTorch's
  CPU sqrt is an ulp off the correctly rounded one in about 0.6% of inputs
  and JAX's ``lax.rsqrt`` is not ``1 / sqrt``, which can move an f16 or u8
  rounding, a floored tile bound or a cull -- counted and capped at 0.5%
  of the gaussians (1% for the stereo frame's two records); theta's u16
  within +-1, or within THETA_TOL u16 units weighted by the record's
  anisotropy (as tests/test_torch_project.py holds it);
* blend attributes of one quantized record: within 4 float32 ulps, or 4
  ulps of the largest value of the field (cos and sin differ by an ulp;
  c1 and c2 are differences of large terms);
* the union pixel bounds of the stereo projection: within 1e-3 relative
  where neither side flipped (as tests/test_torch_stereo.py holds the
  packed projection's: the box extents ride the covariance's
  off-diagonal);
* codecs: both layouts (48-byte float32, 32-byte float16) round-trip byte
  for byte, and the port's bytes equal the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu as G
from gsm_renderer_tpu import types as JT
from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.ops import project as JP

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import types as TT
from gsm_renderer_tpu_torch.ops import project as TP

torch.set_num_threads(1)

W, H, N, FAR = 320, 192, 600, 30.0
THETA_TOL = 4.0
KW = dict(width=W, height=H, tile_w=16, tile_h=16, near_plane=0.1,
          far_plane=FAR, alpha_threshold=0.005, total_ink_threshold=2.0)


def port_input(ds, precision=T.Precision.FLOAT32):
    return T.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                                 ds.opacities, ds.harmonics, precision,
                                 device="cpu")


def theta_error(t_ref, t_got, s1, s2):
    d = np.abs(t_ref.astype(np.int64) - t_got.astype(np.int64))
    d = np.minimum(d, 65536 - d)
    s1, s2 = s1.astype(np.float64), s2.astype(np.float64)
    aniso = np.clip((s1 * s1 - s2 * s2) / np.maximum(s1 * s1, 1e-30), 0.0, 1.0)
    return np.where(d <= 1, 0.0, d * aniso)


def record_differs(ref, got):
    """Per gaussian: a quantized field differs, or theta lies beyond the
    contract."""
    differ = np.zeros(np.asarray(ref.mean_x).shape, bool)
    for f in ("mean_x", "mean_y", "sigma1", "sigma2", "depth"):
        a = np.asarray(getattr(ref, f)).view(np.uint16)
        b = getattr(got, f).numpy().view(np.uint16)
        differ |= a != b
    differ |= np.any(np.asarray(ref.color) != got.color.numpy(), axis=-1)
    differ |= np.asarray(ref.opacity) != got.opacity.numpy()
    s1 = np.asarray(ref.sigma1).astype(np.float32)
    s2 = np.asarray(ref.sigma2).astype(np.float32)
    return differ | (theta_error(np.asarray(ref.theta), got.theta.numpy(), s1,
                                 s2) > THETA_TOL)


def rect_differs(ref, got):
    differ = np.asarray(ref.visible) != got.visible.numpy()
    for f in ("min_tx", "max_tx", "min_ty", "max_ty", "rect_count"):
        differ |= np.asarray(getattr(ref, f)) != getattr(got, f).numpy()
    return differ | (np.asarray(ref.depth_key).astype(np.int64)
                     != got.depth_key.numpy())


SCENES = {
    "sh1": dict(sh_degree=1, seed=3, srgb=False, transform=False),
    "sh3_srgb": dict(sh_degree=3, seed=5, srgb=True, transform=False),
    "sh3_transform": dict(sh_degree=3, seed=7, srgb=False, transform=True),
}


def scene_transform():
    c, s = np.cos(0.3), np.sin(0.3)
    st = np.eye(4, dtype=np.float32)
    st[:3, :3] = 1.25 * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    st[:3, 3] = [0.1, -0.05, 0.2]
    return st


@pytest.mark.parametrize("name", list(SCENES))
def test_project_and_cull_matches_jax(name):
    sc = SCENES[name]
    ds = jax_gen(N, sh_degree=sc["sh_degree"], seed=sc["seed"],
                 scale_range=(0.005, 0.05))
    cam = G.make_camera(W, H, position=(0.1, 0.0, -0.5), far=FAR)
    st = scene_transform() if sc["transform"] else None
    kw = dict(KW, sh_degree=sc["sh_degree"], input_is_srgb=sc["srgb"])
    ref = JP.project_and_cull(
        ds.to_input(), *cam.astuple_jax(), **kw,
        scene_transform=None if st is None else jnp.asarray(st))
    got = TP.project_and_cull(port_input(ds), cam.view_matrix,
                              cam.projection_matrix, cam.position, **kw,
                              scene_transform=st)
    assert got.record.theta.dtype == torch.int32
    assert got.record.color.dtype == torch.uint8 and got.depth_key.dtype == torch.int64
    differ = record_differs(ref.record, got.record) | rect_differs(ref, got)
    assert differ.sum() <= 0.005 * N, f"{differ.sum()} gaussians differ"
    assert got.visible.sum() > N // 3


def test_derive_blend_attributes_matches_jax():
    """The attributes of JAX's own quantized record."""
    ds = jax_gen(N, sh_degree=1, seed=3, scale_range=(0.005, 0.05))
    cam = G.make_camera(W, H, far=FAR)
    rec = JP.project_and_cull(ds.to_input(), *cam.astuple_jax(), **KW,
                              sh_degree=1, input_is_srgb=False).record
    port_rec = TT.RenderRecord(**{
        f: torch.from_numpy(np.asarray(getattr(rec, f)).astype(dt))
        for f, dt in (("mean_x", np.float16), ("mean_y", np.float16),
                      ("theta", np.int32), ("sigma1", np.float16),
                      ("sigma2", np.float16), ("depth", np.float16),
                      ("color", np.uint8), ("opacity", np.uint8))})
    want = JP.derive_blend_attributes(rec)
    got = TP.derive_blend_attributes(port_rec)
    assert set(want) == set(got)
    for k, w in want.items():
        w, g = np.asarray(w).astype(np.float64), got[k].numpy()
        assert g.dtype == np.float32, k
        d = np.abs(g - w)
        ulp = np.spacing(np.maximum(np.abs(w), np.abs(g)).astype(np.float32))
        scale = np.spacing(np.float32(np.abs(w).max()))
        assert ((d <= 4 * ulp) | (d <= 4 * scale)).all(), (k, d.max())


def test_stereo_project_and_cull_matches_jax():
    ds = jax_gen(N, sh_degree=2, seed=11, scale_range=(0.005, 0.05))
    stereo = G.make_side_by_side_stereo(G.make_camera(W, H, far=FAR), ipd=0.2)
    views = np.stack([stereo.left.view_matrix, stereo.right.view_matrix])
    projs = np.stack([stereo.left.projection_matrix,
                      stereo.right.projection_matrix])
    centers = np.stack([stereo.left.position, stereo.right.position])
    st = scene_transform()
    kw = dict(KW, sh_degree=2, input_is_srgb=False)
    ref = JP.stereo_project_and_cull(
        ds.to_input(), jnp.asarray(views), jnp.asarray(projs),
        jnp.asarray(centers), scene_transform=jnp.asarray(st), **kw)
    got = TP.stereo_project_and_cull(port_input(ds), views, projs, centers,
                                     scene_transform=st, **kw)
    differ = (record_differs(ref.record_left, got.record_left)
              | record_differs(ref.record_right, got.record_right)
              | rect_differs(ref, got)
              | np.any(np.asarray(ref.eye_visible) != got.eye_visible.numpy(), 0)
              | (np.asarray(ref.center_depth).view(np.uint16)
                 != got.center_depth.numpy().view(np.uint16)))
    assert differ.sum() <= 0.01 * N, f"{differ.sum()} gaussians differ"
    for f in ("px_min", "px_max", "py_min", "py_max"):
        want = np.asarray(getattr(ref, f))
        d = np.abs(want - getattr(got, f).numpy()) / np.maximum(np.abs(want), 1.0)
        assert d[~differ].max() <= 1e-3, (f, d[~differ].max())
    assert got.eye_visible.shape == (2, N) and got.visible.sum() > N // 3


@pytest.mark.parametrize("precision", [T.Precision.FLOAT32,
                                       T.Precision.FLOAT16])
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_codecs_round_trip_and_match_jax(precision, sh_degree):
    ds = jax_gen(257, sh_degree=sh_degree, seed=2)
    gi = port_input(ds, precision)
    world, harm = T.pack_world_gaussians(gi, precision)
    assert len(world) == 257 * (48 if precision == T.Precision.FLOAT32 else 32)
    jprec = G.Precision(precision.value)
    jworld, jharm = JT.pack_world_gaussians(
        JT.make_gaussian_input(ds.positions, ds.scales, ds.rotations,
                               ds.opacities, ds.harmonics, jprec), jprec)
    assert world == jworld and harm == jharm
    back = T.unpack_world_gaussians(world, precision, harm, sh_degree,
                                    device="cpu")
    for f in ("positions", "scales", "rotations", "opacities", "harmonics"):
        assert torch.equal(getattr(back, f), getattr(gi, f)), f
    assert T.pack_world_gaussians(back, precision) == (world, harm)
    jback = JT.unpack_world_gaussians(world, jprec, harm, sh_degree)
    for f in ("positions", "scales", "rotations", "opacities", "harmonics"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jback, f)))


def test_codecs_default_harmonics_and_bad_buffer():
    ds = jax_gen(10, sh_degree=0, seed=1)
    world, _ = T.pack_world_gaussians(port_input(ds), T.Precision.FLOAT32)
    gi = T.unpack_world_gaussians(world, T.Precision.FLOAT32, sh_degree=1,
                                  device="cpu")
    assert gi.harmonics.shape == (3, 4, 10) and not gi.harmonics.any()
    with pytest.raises(T.RendererError, match="harmonics buffer"):
        T.unpack_world_gaussians(world, T.Precision.FLOAT32,
                                 np.zeros(5, np.float32), 0, device="cpu")
