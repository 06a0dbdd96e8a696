"""Gaussian-splatting math: ``gsm_renderer_tpu/mathlib.py`` in PyTorch.

The component (``_c``) functions work on (N,) float32 tensors and repeat the
JAX function's arithmetic operation for operation (same association order,
same float32 constants), so the plain path and the CUDA kernels that copy it
agree with the reference up to the last-ulp differences of the
transcendental functions; the array-shaped functions are the JAX package's
wrappers around them.  Matrix arguments of the component functions are
nested float32 values (:func:`mat`); the array-shaped ones also take (4, 4)
host arrays.  Their entries enter the arithmetic as float32 scalars.
``rsqrt`` is written ``1 / sqrt``: the CUDA kernels do the same, since
``rsqrtf`` is an approximation.  A Python scalar divided by a tensor, or a
tensor by a Python scalar, goes through :func:`rdiv` / :func:`div` (true
division, as JAX computes it).
"""

from __future__ import annotations

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

PI = float(np.pi)

COV_MIN_VAR = 1e-4
COV_MIN_DET = 1e-8
COV_MAX_AXIS_RATIO = 256.0
COV_BOUNDS_RADIUS = 3.0

MIN_GAUSSIAN_SCALE = 0.0005
MIN_PROJECTED_RADIUS = 0.5


def f32(x) -> float:
    """A Python float holding ``x`` rounded to float32 (how JAX folds a
    Python scalar into float32 arithmetic)."""
    return float(np.float32(x))


def mat(m):
    """(4, 4) or (3,) array -> nested Python floats (float32 values)."""
    a = np.asarray(m, np.float32)
    return a.tolist()


def div(x, c: float):
    """x / c, correctly rounded.  PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can differ in the last bit; a tensor
    divisor keeps the true quotient that JAX and the kernels compute."""
    return x / torch.full_like(x, c)


def rdiv(c: float, x):
    """c / x, correctly rounded (``c / tensor`` is ``reciprocal * c`` in
    PyTorch: two roundings)."""
    return torch.full_like(x, c) / x


def sh_basis_c(x, y, z, degree: int):
    """SH basis values for unit direction components up to ``degree``."""
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return out


def sh_basis(direction, degree: int):
    """SH basis of unit ``direction`` (..., 3) -> (..., n_coeffs)."""
    return torch.stack(sh_basis_c(direction[..., 0], direction[..., 1],
                                  direction[..., 2], degree), dim=-1)


def compute_sh_color_c(harmonics, px, py, pz, camera_center, degree: int):
    """SH colour of N gaussians seen from ``camera_center`` (3,): channel-
    planar ``harmonics`` (3, n_coeffs, N), position components (N,).
    Returns (N, 3) linear colour (before the +0.5 offset)."""
    hp = harmonics.to(torch.float32)
    if degree == 0:
        return torch.stack([hp[ch, 0] * SH_C0 for ch in range(3)], dim=-1)
    cen = mat(camera_center)
    dx = cen[0] - px
    dy = cen[1] - py
    dz = cen[2] - pz
    inv = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    basis = sh_basis_c(dx * inv, dy * inv, dz * inv, degree)
    out = []
    for ch in range(3):
        acc = hp[ch, 0] * basis[0]
        for c in range(1, (degree + 1) ** 2):
            acc = acc + hp[ch, c] * basis[c]
        out.append(acc)
    return torch.stack(out, dim=-1)


def compute_sh_color(harmonics, positions, camera_center, degree: int):
    """SH colour for (N, 3) ``positions`` (see :func:`compute_sh_color_c`)."""
    return compute_sh_color_c(harmonics, positions[..., 0], positions[..., 1],
                              positions[..., 2], camera_center, degree)


def srgb_to_linear(c):
    """Per-channel sRGB decode."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, div(c, 12.92),
                       torch.pow(div(c + 0.055, 1.055), 2.4))


def ndc_to_screen(ndc, width, height):
    """NDC [-1, 1] (..., 2) -> screen pixels [0, size] (..., 2)."""
    return torch.stack([(ndc[..., 0] + 1.0) * 0.5 * width,
                        (ndc[..., 1] + 1.0) * 0.5 * height], dim=-1)


def apply_mat4_c(m, x, y, z):
    """(4, 4) nested floats applied to homogeneous component vectors."""
    return tuple(m[i][0] * x + m[i][1] * y + m[i][2] * z + m[i][3]
                 for i in range(4))


def apply_mat4(m, positions):
    """(4, 4) x (N, 3) homogeneous points -> (N, 4)."""
    return torch.stack(apply_mat4_c(mat(m), positions[..., 0],
                                    positions[..., 1], positions[..., 2]),
                       dim=-1)


def project_points_c(px, py, pz, view, proj, near):
    """Z-sign-agnostic projection.  Returns (vx, vy, vz, ndc_x, ndc_y,
    depth, in_front); ``depth`` is clip.w."""
    vx, vy, vz, _vw = apply_mat4_c(view, px, py, pz)
    cx, cy, _cz, cw = apply_mat4_c(proj, vx, vy, vz)
    depth = cw
    in_front = depth > near
    safe_w = torch.where(depth.abs() > 1e-12, depth, 1e-12)
    inv_w = 1.0 / safe_w
    return vx, vy, vz, cx * inv_w, cy * inv_w, depth, in_front


def project_points(positions, view, proj, near):
    """Project (N, 3) world points: (view positions (N, 3), ndc (N, 2),
    depth, in_front)."""
    vx, vy, vz, nx, ny, depth, in_front = project_points_c(
        positions[..., 0], positions[..., 1], positions[..., 2], mat(view),
        mat(proj), near)
    return (torch.stack([vx, vy, vz], -1), torch.stack([nx, ny], -1), depth,
            in_front)


def normalize_quaternion(quat):
    """(N, 4) quaternions (x, y, z, w) -> unit quaternions."""
    norm = torch.sqrt(torch.clamp((quat * quat).sum(dim=-1, keepdim=True),
                                  min=1e-8))
    return quat / norm


def quaternion_to_matrix(quat):
    """(N, 4) unit quaternions (x, y, z, r) -> (N, 3, 3) rotations."""
    x, y, z, r = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - r * z), 2 * (xz + r * y)], -1)
    row1 = torch.stack([2 * (xy + r * z), 1 - 2 * (xx + zz), 2 * (yz - r * x)], -1)
    row2 = torch.stack([2 * (xz - r * y), 2 * (yz + r * x), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_covariance_3d_c(sx, sy, sz, qx, qy, qz, qw):
    """Sigma = R S S^T R^T from scale and quaternion components; returns the
    six upper-triangle components (c00, c01, c02, c11, c12, c22)."""
    inv_norm = 1.0 / torch.sqrt(
        torch.clamp(qx * qx + qy * qy + qz * qz + qw * qw, min=1e-8))
    x, y, z, r = qx * inv_norm, qy * inv_norm, qz * inv_norm, qw * inv_norm
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    rs = [
        [(1 - 2 * (yy + zz)) * sx, 2 * (xy - r * z) * sy, 2 * (xz + r * y) * sz],
        [2 * (xy + r * z) * sx, (1 - 2 * (xx + zz)) * sy, 2 * (yz - r * x) * sz],
        [2 * (xz - r * y) * sx, 2 * (yz + r * x) * sy, (1 - 2 * (xx + yy)) * sz],
    ]

    def dot(i, j):
        return rs[i][0] * rs[j][0] + rs[i][1] * rs[j][1] + rs[i][2] * rs[j][2]

    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def build_covariance_3d(scales, quats):
    """Sigma = R S S^T R^T for (N, 3) scales and (N, 4) quaternions ->
    (N, 3, 3)."""
    c00, c01, c02, c11, c12, c22 = build_covariance_3d_c(
        scales[..., 0], scales[..., 1], scales[..., 2],
        quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3])
    return _sym3(c00, c01, c02, c11, c12, c22)


def _sym3(c00, c01, c02, c11, c12, c22):
    return torch.stack([torch.stack([c00, c01, c02], -1),
                        torch.stack([c01, c11, c12], -1),
                        torch.stack([c02, c12, c22], -1)], dim=-2)


def _sym2(a, b, d):
    return torch.stack([torch.stack([a, b], -1), torch.stack([b, d], -1)],
                       dim=-2)


def covariance_2d_consts(proj, width, height):
    """Frame constants of :func:`project_covariance_2d_c`, computed in
    float32 as the JAX kernel computes them from its scalar parameters:
    (lim_x, lim_y, focal_x, focal_y)."""
    p00 = np.float32(proj[0][0])
    p11 = np.float32(proj[1][1])
    one, eps = np.float32(1.0), np.float32(1e-4)
    tan_x = one / np.maximum(np.abs(p00), eps)
    tan_y = one / np.maximum(np.abs(p11), eps)
    lim_x = np.float32(1.3) * tan_x
    lim_y = np.float32(1.3) * tan_y
    focal_x = np.float32(width) * np.abs(p00) * np.float32(0.5)
    focal_y = np.float32(height) * np.abs(p11) * np.float32(0.5)
    return float(lim_x), float(lim_y), float(focal_x), float(focal_y)


def project_covariance_2d_c(c3d, vx, vy, vz, view, proj, width, height):
    """EWA 2-D covariance (a, b, d), 0.3 px low-pass added."""
    s00, s01, s02, s11, s12, s22 = c3d
    lim_x, lim_y, focal_x, focal_y = covariance_2d_consts(proj, width, height)
    z = vz
    abs_z = z.abs()
    sign_z = torch.where(z >= 0.0, 1.0, -1.0)
    safe_abs_z = torch.clamp(abs_z, min=1e-4)
    inv_z = 1.0 / safe_abs_z
    inv_z2 = inv_z * inv_z

    x_cl = torch.clamp(vx * inv_z, -lim_x, lim_x) * safe_abs_z
    y_cl = torch.clamp(vy * inv_z, -lim_y, lim_y) * safe_abs_z

    j00 = focal_x * inv_z
    j11 = focal_y * inv_z
    j02 = -focal_x * x_cl * sign_z * inv_z2
    j12 = -focal_y * y_cl * sign_z * inv_z2
    t0 = [j00 * view[0][k] + j02 * view[2][k] for k in range(3)]
    t1 = [j11 * view[1][k] + j12 * view[2][k] for k in range(3)]

    sym = [[s00, s01, s02], [s01, s11, s12], [s02, s12, s22]]

    def m_row(t):
        return [t[0] * sym[0][k] + t[1] * sym[1][k] + t[2] * sym[2][k]
                for k in range(3)]

    m0 = m_row(t0)
    m1 = m_row(t1)
    a = m0[0] * t0[0] + m0[1] * t0[1] + m0[2] * t0[2] + 0.3
    b = m0[0] * t1[0] + m0[1] * t1[1] + m0[2] * t1[2]
    d = m1[0] * t1[0] + m1[1] * t1[1] + m1[2] * t1[2] + 0.3
    return a, b, d


def project_covariance_2d(cov3d, view_pos, view_rot, proj, width, height):
    """(N, 3, 3) cov3d and (N, 3) view-space positions -> (N, 2, 2)
    covariance; ``view_rot`` the (3, 3) upper left of the view matrix."""
    c3d = (cov3d[..., 0, 0], cov3d[..., 0, 1], cov3d[..., 0, 2],
           cov3d[..., 1, 1], cov3d[..., 1, 2], cov3d[..., 2, 2])
    a, b, d = project_covariance_2d_c(
        c3d, view_pos[..., 0], view_pos[..., 1], view_pos[..., 2],
        mat(view_rot), mat(proj), width, height)
    return _sym2(a, b, d)


def max_eigenvalue(width, height) -> float:
    """Screen-bound eigenvalue clamp of :func:`stabilize_covariance_2d_c`,
    in float32."""
    e = np.maximum(np.float32(width), np.float32(height)) * np.float32(2.0)
    e = e / np.float32(COV_BOUNDS_RADIUS)
    return float(e * e)


def _sym_eigen_2x2(a, b, d, min_lambda2):
    det = a * d - b * b
    mid = 0.5 * (a + d)
    disc = torch.clamp(mid * mid - det, min=0.0)
    sqrt_disc = torch.sqrt(disc)
    lam1 = mid + sqrt_disc
    lam2 = torch.clamp(mid - sqrt_disc, min=min_lambda2)
    use_b = b.abs() > 1e-8
    vx = torch.where(use_b, b, torch.where(a >= d, 1.0, 0.0))
    vy = torch.where(use_b, lam1 - a, torch.where(a >= d, 0.0, 1.0))
    vlen = torch.sqrt(vx * vx + vy * vy)
    inv = 1.0 / torch.clamp(vlen, min=1e-8)
    return lam1, lam2, vx * inv, vy * inv


def stabilize_covariance_2d_c(a, b, d, width, height):
    """Variance floors, det repair, screen-bound eigenvalue clamp and 256x
    axis-ratio cap.  Returns (a, b, d)."""
    max_cond = COV_MAX_AXIS_RATIO * COV_MAX_AXIS_RATIO
    max_eig = max_eigenvalue(width, height)

    finite = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(d)
    a = torch.where(finite, a, 1.0)
    b = torch.where(finite, b, 0.0)
    d = torch.where(finite, d, 1.0)

    a = torch.clamp(a, min=COV_MIN_VAR)
    d = torch.clamp(d, min=COV_MIN_VAR)
    det = a * d - b * b
    det = torch.where(torch.isfinite(det), det, 0.0)
    bump = torch.where(det < COV_MIN_DET, (COV_MIN_DET - det) + COV_MIN_VAR, 0.0)
    a = a + bump
    d = d + bump

    lam1, lam2, v1x, v1y = _sym_eigen_2x2(a, b, d, COV_MIN_VAR)
    v2x, v2y = v1y, -v1x
    lam1 = torch.clamp(lam1, max=max_eig)
    lam2 = torch.maximum(lam2, lam1 / max_cond)

    out_a = lam1 * v1x * v1x + lam2 * v2x * v2x
    out_b = lam1 * v1x * v1y + lam2 * v2x * v2y
    out_d = lam1 * v1y * v1y + lam2 * v2y * v2y
    return (torch.where(finite, out_a, 1.0), torch.where(finite, out_b, 0.0),
            torch.where(finite, out_d, 1.0))


def stabilize_covariance_2d(cov2d, width, height):
    """(N, 2, 2) -> (N, 2, 2) stabilized covariance (see
    :func:`stabilize_covariance_2d_c`; the off-diagonal symmetrized)."""
    a, b, d = stabilize_covariance_2d_c(
        cov2d[..., 0, 0], 0.5 * (cov2d[..., 0, 1] + cov2d[..., 1, 0]),
        cov2d[..., 1, 1], width, height)
    return _sym2(a, b, d)


def jmod(x, y: float):
    """``jnp.mod`` for float32: fmod, then + y where the signs differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def major_axis_sigmas_c(a, b, d):
    """:func:`covariance_to_theta_sigmas_c` up to its atan2: (unit major
    eigenvector x, y, sigma1, sigma2, ok)."""
    a = torch.clamp(a, min=1e-8)
    d = torch.clamp(d, min=1e-8)
    finite = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(d)
    det = a * d - b * b
    ok = finite & torch.isfinite(det) & (det > 0.0)
    mid = 0.5 * (a + d)
    disc = torch.clamp(mid * mid - det, min=0.0)
    sqrt_disc = torch.sqrt(disc)
    lam1 = torch.clamp(mid + sqrt_disc, min=1e-8)
    lam2 = torch.clamp(mid - sqrt_disc, min=1e-8)
    use_b = b.abs() > 1e-8
    vx = torch.where(use_b, b, torch.where(a >= d, 1.0, 0.0))
    vy = torch.where(use_b, lam1 - a, torch.where(a >= d, 0.0, 1.0))
    vlen = torch.sqrt(vx * vx + vy * vy)
    vx = vx / torch.clamp(vlen, min=1e-12)
    vy = vy / torch.clamp(vlen, min=1e-12)
    sigma1 = torch.sqrt(lam1)
    sigma2 = torch.sqrt(lam2)
    ok &= torch.isfinite(sigma1) & torch.isfinite(sigma2)
    return vx, vy, sigma1, sigma2, ok


def covariance_to_theta_sigmas_c(a, b, d):
    """Eigen-decomposition of the covariance (a, b, d): (theta in [0, pi),
    sigma1, sigma2, ok)."""
    vx, vy, sigma1, sigma2, ok = major_axis_sigmas_c(a, b, d)
    theta = jmod(torch.atan2(vy, vx), PI)
    theta = torch.where(theta >= PI, theta - PI, theta)
    return theta, sigma1, sigma2, ok & torch.isfinite(theta)


def covariance_to_theta_sigmas(cov2d):
    """(N, 2, 2) -> (theta, sigma1, sigma2, ok); the off-diagonal
    symmetrized."""
    return covariance_to_theta_sigmas_c(
        cov2d[..., 0, 0], 0.5 * (cov2d[..., 0, 1] + cov2d[..., 1, 0]),
        cov2d[..., 1, 1])


def pack_theta_u16(theta):
    """theta [0, pi) -> u16 (int32 holding it)."""
    t = jmod(theta, PI)
    t = torch.where(t < 0.0, t + PI, t)
    u = t * (65535.0 / PI)
    return torch.clamp(u + 0.5, 0.0, 65535.0).to(torch.int32)


def unpack_theta_u16(packed):
    """u16 -> theta (float32)."""
    return packed.to(torch.float32) * (PI / 65535.0)


def conic_from_theta_sigmas(theta, sigma1, sigma2, min_sigma: float = 1e-4):
    """(theta, s1, s2) -> conic (A, B, C), q = A dx^2 + 2B dx dy + C dy^2,
    the sigmas floored at ``min_sigma``."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    s1 = torch.clamp(sigma1, min=min_sigma)
    s2 = torch.clamp(sigma2, min=min_sigma)
    iv1 = rdiv(1.0, s1 * s1)
    iv2 = rdiv(1.0, s2 * s2)
    cc, ss, cs = c * c, s * s, c * s
    return cc * iv1 + ss * iv2, cs * (iv1 - iv2), ss * iv1 + cc * iv2


def compute_obb_extents_c(a, b, d, sigma_multiplier=3.0):
    """Axis-aligned extents of the oriented 3-sigma box: (x_ext, y_ext)."""
    det = a * d - b * b
    mid = 0.5 * (a + d)
    disc = torch.clamp(mid * mid - det, min=1e-6)
    sqrt_disc = torch.sqrt(disc)
    lam1 = mid + sqrt_disc
    lam2 = torch.clamp(mid - sqrt_disc, min=1e-6)
    e1 = sigma_multiplier * torch.sqrt(torch.clamp(lam1, min=1e-6))
    e2 = sigma_multiplier * torch.sqrt(torch.clamp(lam2, min=1e-6))
    use_b = b.abs() > 1e-6
    vx = torch.where(use_b, b, torch.where(a >= d, 1.0, 0.0))
    vy = torch.where(use_b, lam1 - a, torch.where(a >= d, 0.0, 1.0))
    vlen = torch.clamp(torch.sqrt(vx * vx + vy * vy), min=1e-6)
    vx, vy = vx / vlen, vy / vlen
    return vx.abs() * e1 + vy.abs() * e2, vy.abs() * e1 + vx.abs() * e2


def compute_obb_extents(cov2d, sigma_multiplier=3.0):
    """Axis-aligned extents (N, 2) of the oriented box of (N, 2, 2)."""
    ex, ey = compute_obb_extents_c(cov2d[..., 0, 0], cov2d[..., 0, 1],
                                   cov2d[..., 1, 1], sigma_multiplier)
    return torch.stack([ex, ey], dim=-1)


def compute_conic_and_radius(cov2d):
    """Inverse conic (N, 3) and conservative radius of (N, 2, 2)."""
    a, b = cov2d[..., 0, 0], cov2d[..., 0, 1]
    c, d = cov2d[..., 1, 0], cov2d[..., 1, 1]
    det = a * d - b * c
    inv_det = rdiv(1.0, torch.clamp(det, min=1e-8))
    conic = torch.stack([d * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + d)
    delta = torch.clamp(mid * mid - det, min=1e-5)
    max_eig = mid + torch.sqrt(delta)
    radius = 3.0 * torch.ceil(torch.sqrt(torch.clamp(max_eig, min=1e-5)))
    return conic, radius


def eval_quad(x, y, a, b, c):
    """q(x, y) = a x^2 + 2 b x y + c y^2."""
    return a * x * x + 2.0 * b * x * y + c * y * y


def min_quad_rect(xmin, xmax, ymin, ymax, a, b, c):
    """Exact minimum of the conic quadratic over an axis-aligned rect
    relative to the mean (broadcastable)."""
    inside = (xmin <= 0.0) & (0.0 <= xmax) & (ymin <= 0.0) & (0.0 <= ymax)
    inv_a = rdiv(1.0, torch.clamp(a, min=1e-20))
    inv_c = rdiv(1.0, torch.clamp(c, min=1e-20))

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    q1 = eval_quad(xmin, clip(-(b * inv_c) * xmin, ymin, ymax), a, b, c)
    q2 = eval_quad(xmax, clip(-(b * inv_c) * xmax, ymin, ymax), a, b, c)
    q3 = eval_quad(clip(-(b * inv_a) * ymin, xmin, xmax), ymin, a, b, c)
    q4 = eval_quad(clip(-(b * inv_a) * ymax, xmin, xmax), ymax, a, b, c)
    qmin = torch.minimum(torch.minimum(q1, q2), torch.minimum(q3, q4))
    return torch.where(inside, 0.0, qmin)


def gaussian_compute_power(opacity):
    """ln2 * 8 + ln2 * log2(opacity)."""
    ln2 = 0.693147180559945
    return ln2 * 8.0 + ln2 * torch.log2(torch.clamp(opacity, min=1e-6))


def _segment_intersect_ellipse(a, b, c, d, lo, hi):
    delta = b * b - 4.0 * a * c
    t1 = (lo - d) * (2.0 * a) + b
    t2 = (hi - d) * (2.0 * a) + b
    return ((delta >= 0.0) & ((t1 <= 0.0) | (t1 * t1 <= delta))
            & ((t2 >= 0.0) | (t2 * t2 <= delta)))


def gaussian_intersects_tile(pix_min_x, pix_min_y, pix_max_x, pix_max_y,
                             center_x, center_y, conic_a, conic_b, conic_c,
                             power):
    """Ellipse vs tile test; ``conic_*`` the inverse-covariance triple,
    ``power`` from :func:`gaussian_compute_power` (broadcastable)."""
    contains = ((center_x >= pix_min_x) & (center_x <= pix_max_x)
                & (center_y >= pix_min_y) & (center_y <= pix_max_y))
    w = 2.0 * power
    dx = torch.where(center_x * 2.0 < pix_min_x + pix_max_x,
                     center_x - pix_min_x, center_x - pix_max_x)
    hit_v = _segment_intersect_ellipse(
        conic_c, -2.0 * conic_b * dx, conic_a * dx * dx - w, center_y,
        pix_min_y, pix_max_y)
    dy = torch.where(center_y * 2.0 < pix_min_y + pix_max_y,
                     center_y - pix_min_y, center_y - pix_max_y)
    hit_h = _segment_intersect_ellipse(
        conic_a, -2.0 * conic_b * dy, conic_c * dy * dy - w, center_x,
        pix_min_x, pix_max_x)
    return contains | hit_v | hit_h


def cull_by_scale_c(sx, sy, sz):
    return torch.maximum(torch.maximum(sx, sy), sz) < MIN_GAUSSIAN_SCALE


def cull_by_scale(scales):
    """Max scale of (N, 3) below MIN_GAUSSIAN_SCALE."""
    return cull_by_scale_c(scales[..., 0], scales[..., 1], scales[..., 2])


def cull_by_radius(radius):
    return radius < MIN_PROJECTED_RADIUS


def cull_by_far_plane(depth, far_plane):
    return depth > far_plane


def depth_factor_consts(near_plane, far_plane):
    """(adjusted_far, adjusted_far - near) as JAX folds them: computed in
    Python double, then rounded to float32."""
    adjusted_far = far_plane * 0.02
    return f32(adjusted_far), f32(adjusted_far - near_plane)


def compute_depth_factor(depth, near_plane, far_plane):
    """LOD depth factor 1 - t^2, t = clip((far/50 - depth) / (far/50 -
    near), 0, 1)."""
    af, den = depth_factor_consts(near_plane, far_plane)
    t = torch.clamp(div(af - depth, den), 0.0, 1.0)
    return 1.0 - t * t


def cull_by_total_ink(opacity, det_cov2d, depth, near_plane, far_plane,
                      threshold):
    """Total-ink cull with the depth-adaptive threshold."""
    if threshold <= 0.0:
        return torch.zeros_like(depth, dtype=torch.bool)
    total_ink = opacity * 6.283185 * torch.sqrt(torch.clamp(det_cov2d, min=1e-12))
    return total_ink < compute_depth_factor(depth, near_plane,
                                            far_plane) * threshold


def cull_by_screen_bounds_c(sx, sy, ex, ey, width, height):
    return ((sx + ex < 0.0) | (sx - ex > width)
            | (sy + ey < 0.0) | (sy - ey > height))


def cull_by_screen_bounds(screen, obb_extents, width, height):
    """Off-screen cull of (N, 2) screen means with (N, 2) extents."""
    return cull_by_screen_bounds_c(screen[..., 0], screen[..., 1],
                                   obb_extents[..., 0], obb_extents[..., 1],
                                   width, height)


def compute_tile_bounds_c(sx, sy, ex, ey, width, height, tile_w, tile_h,
                          tiles_x, tiles_y):
    """Clamped inclusive tile rect (int32 min_tx, max_tx, min_ty, max_ty);
    invalid when min > max.

    The JAX function divides by the static tile side under ``jax.jit``,
    where XLA folds a division by a constant into a multiply by its float32
    reciprocal; this multiplies by ``f32(1 / side)`` the same way.  At a
    power-of-two side that is the exact quotient; at another side a bound
    within an ulp of a tile edge can floor to the next tile, as it does in
    the jitted reference."""
    xmin = torch.clamp(sx - ex, 0.0, width - 1.0)
    xmax = torch.clamp(sx + ex, 0.0, width - 1.0)
    ymin = torch.clamp(sy - ey, 0.0, height - 1.0)
    ymax = torch.clamp(sy + ey, 0.0, height - 1.0)
    i32 = torch.int32
    rw, rh = f32(1.0 / tile_w), f32(1.0 / tile_h)
    min_tx = torch.clamp(torch.floor(xmin * rw).to(i32), min=0)
    max_tx = torch.clamp(torch.ceil(xmax * rw).to(i32) - 1, max=tiles_x - 1)
    min_ty = torch.clamp(torch.floor(ymin * rh).to(i32), min=0)
    max_ty = torch.clamp(torch.ceil(ymax * rh).to(i32) - 1, max=tiles_y - 1)
    return min_tx, max_tx, min_ty, max_ty


def compute_tile_bounds(screen, obb_extents, width, height, tile_w, tile_h,
                        tiles_x, tiles_y):
    """Clamped inclusive tile rect of (N, 2) screen means and extents."""
    return compute_tile_bounds_c(screen[..., 0], screen[..., 1],
                                 obb_extents[..., 0], obb_extents[..., 1],
                                 width, height, tile_w, tile_h, tiles_x,
                                 tiles_y)


def compute_d2_cutoff(opacity, tau):
    """Alpha cutoff in squared-Mahalanobis units; -1 if opacity < tau."""
    return torch.where(opacity < tau, -1.0,
                       -2.0 * torch.log(rdiv(tau, torch.clamp(opacity, min=1e-30))))


U32 = 0xFFFFFFFF


def u32(x):
    """int32 bit-holding tensor -> int64 tensor of the unsigned value."""
    return x.to(torch.int64) & U32


def to_i32(x):
    """int64 tensor of a 32-bit unsigned value -> int32 tensor holding the
    same bits."""
    x = x & U32
    return torch.where(x >= 0x80000000, x - (1 << 32), x).to(torch.int32)


def float_to_sortable_uint(v):
    """IEEE float32 -> order-preserving unsigned key (int64 holding u32)."""
    bits = u32(v.contiguous().view(torch.int32))
    mask = torch.where((bits & 0x80000000) != 0, 0xFFFFFFFF, 0x80000000)
    return bits ^ mask


def sortable_uint_to_float(u):
    """Inverse of :func:`float_to_sortable_uint`: int64 tensor holding u32
    keys -> float32."""
    u = u & U32
    bits = torch.where((u & 0x80000000) != 0, u ^ 0x80000000, u ^ U32)
    return to_i32(bits).view(torch.float32)


def half_key16(h):
    """16-bit sortable key of float16 bits ``h`` (int64): bits ^ 0x8000,
    with the order of negative halves reversed so that the mapping is
    monotonic over all finite values."""
    return torch.where((h & 0x8000) != 0, (~h) & 0xFFFF, h ^ 0x8000)


def half_depth_key16(depth):
    """Depth -> 16-bit sortable key (int64): the float16 bits of ``depth``
    (round to nearest even) through :func:`half_key16`."""
    h = depth.to(torch.float32).to(torch.float16).view(torch.int16)
    return half_key16(h.to(torch.int64) & 0xFFFF)
