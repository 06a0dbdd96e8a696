"""The 27 public functions of gsm_renderer_tpu_torch.mathlib that the port
added for the unpacked projection (``ops/project.py``) against
gsm_renderer_tpu.mathlib, on seeded numpy inputs given to both.

Tolerances (the ROADMAP parity contract): integer and boolean outputs are
equal.  A float output is within ULPS float32 ulps of the JAX value (the
ulp of the larger of the two), or within SCALE_ULPS ulps of the largest
JAX output of the call, where a value is a small difference of large
terms.  Two sources of difference, both measured here: PyTorch's CPU sqrt
is not correctly rounded (an ulp off in about 0.6% of inputs; XLA's is),
JAX's ``lax.rsqrt`` is not ``1 / sqrt``, and the transcendentals (exp,
log, log2, pow, sin, cos, atan2) of XLA:CPU and PyTorch differ by about
an ulp.  Per function (CASES), measured worst cases in brackets:
* arithmetic alone (apply_mat4, quaternion_to_matrix, eval_quad,
  min_quad_rect, project_points, ...): 0 -- bit-equal (JAX runs op by op
  here: nothing is contracted into an FMA);
* the SH colour (rsqrt; sums that cancel near 0): 4 ulps or 4 ulps of the
  scale [3];
* build_covariance_3d (rsqrt of the quaternion norm; off-diagonal
  cancellation): 4 ulps or 16 of the scale [11.5];
* through sin, cos, log, log2, pow: a few ulps [4 or less];
* the u16 theta packing, the tile bounds and the culls: equal.

The 2x2 eigen-decompositions (stabilize_covariance_2d,
covariance_to_theta_sigmas and its ``_c`` form, compute_obb_extents) are
held otherwise (EIGEN_CASES): no bound between two float32 runs holds on
every CPU there, because the eigenvector (b, lam1 - a) cancels and both
packages' rounding (and JAX's own eager against ``jit``) moves it by
thousands of ulps on ill-conditioned inputs.  Both the JAX and the port
outputs are held to a float64 run of the same formula (the port's
function on float64 tensors: every constant is a Python float), each
element within ULPS ulps of it or within EIGEN_K times its own
first-order error bound, from the float64 terms of its input (a, b, d):
u = 2^-24, S = max(|a|, |d|) (|b| <= S for a covariance), s = sqrt(((a -
d) / 2)^2 + b^2) the half gap of the eigenvalues, lam1,2 = (a + d) / 2 +-
s, r = |(b, lam1 - a)|, sigma = sqrt(lam).
1. float32 ``disc = mid^2 - det`` carries an absolute error of a few
   u S^2, so its square root s carries ds = u (S + S^2 / s) (the root
   halves the first term's factor and adds its own rounding, u s <= u S).
2. ``vy = lam1 - a`` carries ds plus a few u S, so the unit eigenvector
   (b, vy) / r turns by dth = (ds + u S) / r radians.
3. The outputs: theta dth (distance taken modulo pi: theta wraps at 0 and
   pi); sigma (u S + ds) / (2 sigma); the stabilized covariance, which is
   mid I + s (2 v v^T - I), u S + ds + 2 s dth; the OBB extents |vx| e1 +
   |vy| e2 (e = 3 sigma), dth (e1 + e2) + de1 + de2 with de = 3 (u S +
   ds) / (2 sigma).
The worst element reaches 1.25 (stabilize), 2.34 (sigma1), 1.61 (theta),
1.54 (sigma2) and 0.51 (extents) times its bound here: EIGEN_K = 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsm_renderer_tpu.mathlib as JM

import gsm_renderer_tpu_torch.mathlib as TM

torch.set_num_threads(1)

N = 4096
W, H = 1920.0, 1080.0


def rng():
    return np.random.default_rng(1234)


def unit(r, n, k):
    v = r.normal(size=(n, k)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def uni(r, lo, hi, shape):
    return r.uniform(lo, hi, shape).astype(np.float32)


def spd(r, n):
    """(n, 2, 2) covariances of sigmas 0.3-60 px at random angles."""
    s1, s2 = uni(r, 0.3, 60.0, n), uni(r, 0.3, 60.0, n)
    t = uni(r, 0.0, np.pi, n)
    c, s = np.cos(t), np.sin(t)
    a = c * c * s1 * s1 + s * s * s2 * s2
    b = c * s * (s1 * s1 - s2 * s2)
    d = s * s * s1 * s1 + c * c * s2 * s2
    return np.stack([np.stack([a, b], -1), np.stack([b, d], -1)], -2).astype(np.float32)


def camera():
    import gsm_renderer_tpu as G
    cam = G.make_camera(1920, 1080, position=(0.3, -0.2, 0.5), far=50.0)
    return (np.asarray(cam.view_matrix, np.float32),
            np.asarray(cam.projection_matrix, np.float32))


def points(r, n):
    return np.stack([uni(r, -4, 4, n), uni(r, -3, 3, n), uni(r, 1, 20, n)], -1)


def mat4(r):
    m = r.normal(size=(4, 4)).astype(np.float32)
    m[3] = [0, 0, 0, 1]
    return m


def harmonics(r, n, degree):
    return uni(r, -0.5, 0.5, (3, (degree + 1) ** 2, n))


def cov3d(r, n):
    q = unit(r, n, 4)
    return np.asarray(JM.build_covariance_3d(jnp.asarray(uni(r, 0.01, 0.3, (n, 3))),
                                             jnp.asarray(q)))


def theta_sigmas(r, n):
    return uni(r, -1.0, 4.0, n), uni(r, 0.0, 50.0, n), uni(r, 0.0, 50.0, n)


def tile_test_args(r, n):
    cov = spd(r, n)
    conic, _ = JM.compute_conic_and_radius(jnp.asarray(cov))
    conic = np.asarray(conic)
    x0, y0 = uni(r, 0, 1900, n), uni(r, 0, 1060, n)
    cx, cy = x0 + uni(r, -60, 76, n), y0 + uni(r, -60, 76, n)
    power = np.asarray(JM.gaussian_compute_power(jnp.asarray(uni(r, 0.01, 1, n))))
    return (x0, y0, x0 + 16.0, y0 + 16.0, cx, cy, conic[:, 0], conic[:, 1],
            conic[:, 2], power)


def quad_args(r, n):
    a, b, c = (np.asarray(x) for x in JM.conic_from_theta_sigmas(
        *(jnp.asarray(v) for v in (uni(r, 0, 3.1, n), uni(r, 0.5, 40, n),
                                   uni(r, 0.5, 40, n)))))
    xmin, ymin = uni(r, -80, 80, n), uni(r, -80, 80, n)
    return xmin, xmin + 16.0, ymin, ymin + 16.0, a, b, c


#: name -> (argument builder, keyword arguments, ULPS, SCALE_ULPS); SCALE_ULPS
#: None: an eigen-decomposition, held to float64 (EIGEN_CASES)
CASES = {
    "sh_basis": (lambda r: (unit(r, N, 3), 3), {}, 0, 0),
    "compute_sh_color": (lambda r: (harmonics(r, N, 3), points(r, N),
                                    np.float32([0.3, -0.2, 0.5]), 3), {}, 4, 4),
    "compute_sh_color_c": (lambda r: (harmonics(r, N, 2), *points(r, N).T,
                                      np.float32([0.1, 0.2, -0.3]), 2), {}, 4, 4),
    "srgb_to_linear": (lambda r: (uni(r, -0.2, 1.2, N),), {}, 2, 0),
    "ndc_to_screen": (lambda r: (uni(r, -1.5, 1.5, (N, 2)), W, H), {}, 0, 0),
    "apply_mat4": (lambda r: (mat4(r), points(r, N)), {}, 0, 0),
    "project_points": (lambda r: (points(r, N), *camera(), 0.1), {}, 0, 0),
    "normalize_quaternion": (lambda r: (uni(r, -1, 1, (N, 4)),), {}, 2, 0),
    "quaternion_to_matrix": (lambda r: (unit(r, N, 4),), {}, 0, 0),
    "build_covariance_3d": (lambda r: (uni(r, 0.01, 0.3, (N, 3)),
                                       uni(r, -1, 1, (N, 4))), {}, 4, 16),
    "project_covariance_2d": (lambda r: (cov3d(r, N), points(r, N),
                                         camera()[0][:3, :3], camera()[1], W, H),
                              {}, 2, 0),
    "stabilize_covariance_2d": (lambda r: (spd(r, N), W, H), {}, 4, None),
    "covariance_to_theta_sigmas": (lambda r: (spd(r, N),), {}, 4, None),
    "covariance_to_theta_sigmas_c": (
        lambda r: tuple(spd(r, N).reshape(N, 4)[:, [0, 1, 3]].T), {}, 4, None),
    "pack_theta_u16": (lambda r: (uni(r, -4, 7, N),), {}, 0, 0),
    "unpack_theta_u16": (lambda r: (r.integers(0, 65536, N).astype(np.int32),),
                         {}, 0, 0),
    "conic_from_theta_sigmas": (lambda r: theta_sigmas(r, N), {}, 6, 0),
    "compute_obb_extents": (lambda r: (spd(r, N), 3.0), {}, 4, None),
    "compute_conic_and_radius": (lambda r: (spd(r, N),), {}, 2, 0),
    "eval_quad": (lambda r: tuple(uni(r, -5, 5, N) for _ in range(5)), {}, 0, 0),
    "min_quad_rect": (lambda r: quad_args(r, N), {}, 0, 0),
    "gaussian_compute_power": (lambda r: (uni(r, 0.0, 1.0, N),), {}, 2, 2),
    "gaussian_intersects_tile": (lambda r: tile_test_args(r, N), {}, 0, 0),
    "cull_by_scale": (lambda r: (uni(r, 0.0, 0.002, (N, 3)),), {}, 0, 0),
    "compute_depth_factor": (lambda r: (uni(r, 0.0, 2.0, N), 0.1, 50.0), {}, 2, 0),
    "cull_by_screen_bounds": (lambda r: (uni(r, -100, 2000, (N, 2)),
                                         uni(r, 0, 80, (N, 2)), W, H), {}, 0, 0),
    "compute_tile_bounds": (lambda r: (uni(r, -100, 2000, (N, 2)),
                                       uni(r, 0, 80, (N, 2)), W, H, 16, 16,
                                       120, 68), {}, 0, 0),
}

#: multiple of an eigen-decomposition element's first-order error bound
EIGEN_K = 4.0
U32 = 2.0 ** -24


def eigen_terms(args, name):
    """Float64 terms (S, s, lam1, lam2, ds, dth) of the module docstring for
    the (a, b, d) that ``name`` decomposes (the off-diagonal symmetrized,
    as the functions do)."""
    if name.endswith("_c"):
        a, b, d = (np.asarray(x, np.float64) for x in args[:3])
    else:
        cov = np.asarray(args[0], np.float64)
        a, b, d = cov[:, 0, 0], 0.5 * (cov[:, 0, 1] + cov[:, 1, 0]), cov[:, 1, 1]
    S = np.maximum(np.abs(a), np.abs(d))
    mid = 0.5 * (a + d)
    s = np.sqrt(np.maximum(mid * mid - (a * d - b * b), 0.0))
    lam1 = mid + s
    lam2 = np.maximum(mid - s, 1e-8)
    r = np.hypot(b, lam1 - a)
    with np.errstate(divide="ignore"):
        ds = U32 * (S + S * S / s)
        dth = (ds + U32 * S) / r
    return S, s, lam1, lam2, ds, dth


def eigen_bounds(args, name):
    """Each float output's per-element first-order error bound."""
    S, s, lam1, lam2, ds, dth = eigen_terms(args, name)
    dlam = U32 * S + ds
    sig1, sig2 = np.sqrt(lam1), np.sqrt(lam2)
    if name == "stabilize_covariance_2d":
        return [(dlam + 2.0 * s * dth)[:, None, None]]
    if name == "compute_obb_extents":
        e1, e2 = 3.0 * sig1, 3.0 * sig2
        de = 3.0 * dlam / (2.0 * sig1) + 3.0 * dlam / (2.0 * sig2)
        return [(dth * (e1 + e2) + de)[:, None]]
    return [dth, dlam / (2.0 * sig1), dlam / (2.0 * sig2)]


def float64_run(name, args, kw):
    return flat(getattr(TM, name)(*(
        torch.from_numpy(a.astype(np.float64)) if isinstance(a, np.ndarray)
        else a for a in args), **kw))


def to_jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def to_torch(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


def flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in flat(x)]
    return [out]


def ulps_apart(want, got):
    """|got - want| in float32 ulps of the larger magnitude."""
    want, got = want.astype(np.float64), got.astype(np.float64)
    scale = np.spacing(np.maximum(np.abs(want), np.abs(got)).astype(np.float32))
    return np.abs(got - want) / scale.astype(np.float64)


def test_every_public_jax_function_is_ported():
    import inspect
    jax_fns = {n for n, v in vars(JM).items() if inspect.isfunction(v)
               and not n.startswith("_") and v.__module__ == JM.__name__}
    port_fns = {n for n, v in vars(TM).items() if inspect.isfunction(v)}
    assert jax_fns <= port_fns, sorted(jax_fns - port_fns)
    assert set(CASES) | {n for n in jax_fns if n.endswith("_c") or n in (
        "compute_d2_cutoff", "cull_by_radius", "cull_by_far_plane",
        "cull_by_total_ink", "float_to_sortable_uint",
        "sortable_uint_to_float", "half_depth_key16")} >= jax_fns


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    build, kw, ulps, scale_ulps = CASES[name]
    args = build(rng())
    want = flat(getattr(JM, name)(*(to_jax(a) for a in args), **kw))
    got = flat(getattr(TM, name)(*(to_torch(a) for a in args), **kw))
    assert len(want) == len(got)
    if scale_ulps is None:
        ref, bounds = float64_run(name, args, kw), iter(eigen_bounds(args, name))
    for k, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, (w.shape, g.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))
            continue
        assert g.dtype == np.float32, g.dtype
        if scale_ulps is None:
            check_eigen_output(name, k, ref[k].numpy(), next(bounds), ulps,
                               jax=w, port=g)
            continue
        err = ulps_apart(w, g)
        scale = np.spacing(np.float32(np.abs(w).max()))
        ok = (err <= ulps) | (np.abs(g.astype(np.float64) - w)
                              <= scale_ulps * float(scale))
        assert ok.all(), (f"{(~ok).sum()} of {ok.size} beyond {ulps} ulps / "
                          f"{scale_ulps} ulps of the scale; worst {err.max()} "
                          "ulps")


def check_eigen_output(name, k, ref, bound, ulps, **outs):
    """Every output of ``outs`` within ``ulps`` ulps of the float64 run
    ``ref`` or within EIGEN_K times ``bound``, element by element (theta's
    distance modulo pi)."""
    theta = name.startswith("covariance_to_theta") and k == 0
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    for who, x in outs.items():
        err = np.abs(x.astype(np.float64) - ref)
        if theta:
            err = np.minimum(err, np.pi - err)
        ok = (err <= ulps * ulp) | (err <= EIGEN_K * bound)
        assert ok.all(), (f"{who} output {k}: {(~ok).sum()} of {ok.size} "
                          f"beyond {ulps} ulps of float64 and {EIGEN_K} x "
                          f"the bound; worst {np.max(err / bound)} x the bound")
