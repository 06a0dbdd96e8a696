"""Gaussian-splatting math: the part of ``gsm_renderer_tpu/mathlib.py`` that
projection and binning call, in PyTorch.

Every function works on (N,) float32 component tensors and repeats the JAX
function's arithmetic operation for operation (same association order, same
float32 constants), so the plain path and the CUDA kernels that copy it agree
with the reference up to the last-ulp differences of the transcendental
functions.  Matrix arguments are (4, 4) host arrays; their entries enter the
arithmetic as float32 scalars.  ``rsqrt`` is written ``1 / sqrt``: the CUDA
kernels do the same, since ``rsqrtf`` is an approximation.
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


def apply_mat4_c(m, x, y, z):
    """(4, 4) nested floats applied to homogeneous component vectors."""
    return tuple(m[i][0] * x + m[i][1] * y + m[i][2] * z + m[i][3]
                 for i in range(4))


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


def cull_by_scale_c(sx, sy, sz):
    return torch.maximum(torch.maximum(sx, sy), sz) < MIN_GAUSSIAN_SCALE


def cull_by_radius(radius):
    return radius < MIN_PROJECTED_RADIUS


def cull_by_far_plane(depth, far_plane):
    return depth > far_plane


def depth_factor_consts(near_plane, far_plane):
    """(adjusted_far, adjusted_far - near) as JAX folds them: computed in
    Python double, then rounded to float32."""
    adjusted_far = far_plane * 0.02
    return f32(adjusted_far), f32(adjusted_far - near_plane)


def cull_by_total_ink(opacity, det_cov2d, depth, near_plane, far_plane,
                      threshold):
    """Total-ink cull with the depth-adaptive threshold."""
    if threshold <= 0.0:
        return torch.zeros_like(depth, dtype=torch.bool)
    af, den = depth_factor_consts(near_plane, far_plane)
    total_ink = opacity * 6.283185 * torch.sqrt(torch.clamp(det_cov2d, min=1e-12))
    t = torch.clamp(div(af - depth, den), 0.0, 1.0)
    return total_ink < (1.0 - t * t) * threshold


def cull_by_screen_bounds_c(sx, sy, ex, ey, width, height):
    return ((sx + ex < 0.0) | (sx - ex > width)
            | (sy + ey < 0.0) | (sy - ey > height))


def compute_tile_bounds_c(sx, sy, ex, ey, width, height, tile_w, tile_h,
                          tiles_x, tiles_y):
    """Clamped inclusive tile rect (int32 min_tx, max_tx, min_ty, max_ty);
    invalid when min > max."""
    xmin = torch.clamp(sx - ex, 0.0, width - 1.0)
    xmax = torch.clamp(sx + ex, 0.0, width - 1.0)
    ymin = torch.clamp(sy - ey, 0.0, height - 1.0)
    ymax = torch.clamp(sy + ey, 0.0, height - 1.0)
    i32 = torch.int32
    min_tx = torch.clamp(torch.floor(xmin / tile_w).to(i32), min=0)
    max_tx = torch.clamp(torch.ceil(xmax / tile_w).to(i32) - 1, max=tiles_x - 1)
    min_ty = torch.clamp(torch.floor(ymin / tile_h).to(i32), min=0)
    max_ty = torch.clamp(torch.ceil(ymax / tile_h).to(i32) - 1, max=tiles_y - 1)
    return min_tx, max_tx, min_ty, max_ty


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
