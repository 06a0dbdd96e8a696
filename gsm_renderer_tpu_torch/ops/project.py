"""Project + cull in plain PyTorch: the unpacked projection of the JAX
package's ``ops/project.py`` (``project_and_cull``, ``derive_blend_attributes``
and ``stereo_project_and_cull``).

The renderers of this package take the packed projection of
``kernels/project.py`` (a CUDA kernel and its plain version), which yields
the same record words, rect words and depth keys in one pass
(tests/test_torch_hardware.py holds it against this module's JAX twin on
the Hardware frame).  This module keeps the unpacked form -- quantized
:class:`~gsm_renderer_tpu_torch.types.RenderRecord`, tile bounds, rect
counts and sortable depth keys -- for the callers that want the per-gaussian
fields themselves.  It runs on any device, on (N,) component tensors,
operation for operation as the JAX functions; matrices are host arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import mathlib as M
from ..types import RenderRecord


@dataclasses.dataclass
class ProjectionResult:
    """Per-gaussian outputs of the project+cull stage (length-N tensors):
    the quantized record, ``visible`` (bool, passed every cull), the
    clamped inclusive tile rect (int32; 0 / -1 where culled),
    ``rect_count`` (rect_w * rect_h where visible, else 0) and the sortable
    ``depth_key`` (int64 holding u32; 0xFFFFFFFF where culled)."""

    record: RenderRecord
    visible: torch.Tensor
    min_tx: torch.Tensor
    max_tx: torch.Tensor
    min_ty: torch.Tensor
    max_ty: torch.Tensor
    rect_count: torch.Tensor
    depth_key: torch.Tensor


def _u8(x):
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def _rect(alive, min_tx, max_tx, min_ty, max_ty):
    rect_w = max_tx - min_tx + 1
    rect_h = max_ty - min_ty + 1
    rect_count = torch.where(alive, rect_w * rect_h, 0).to(torch.int32)
    return dict(min_tx=torch.where(alive, min_tx, 0),
                max_tx=torch.where(alive, max_tx, -1),
                min_ty=torch.where(alive, min_ty, 0),
                max_ty=torch.where(alive, max_ty, -1), rect_count=rect_count)


def project_and_cull(gi, view, proj, camera_center, *, width: int, height: int,
                     tile_w: int, tile_h: int, sh_degree: int,
                     near_plane: float, far_plane: float,
                     alpha_threshold: float, total_ink_threshold: float,
                     input_is_srgb: bool,
                     scene_transform=None) -> ProjectionResult:
    """Projection, culling and record quantization of N gaussians.
    ``view``, ``proj`` (4, 4), ``camera_center`` (3,) and the optional
    ``scene_transform`` (4, 4) are host arrays."""
    f32 = torch.float32
    pos = gi.positions.to(f32)
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    if scene_transform is not None:
        px, py, pz, _ = M.apply_mat4_c(M.mat(scene_transform), px, py, pz)
    sc, rot = gi.scales.to(f32), gi.rotations.to(f32)
    sx, sy, sz = sc[:, 0], sc[:, 1], sc[:, 2]
    opacity = gi.opacities.to(f32)
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)

    alive = ~M.cull_by_scale_c(sx, sy, sz)
    vx, vy, vz, nx, ny, depth, in_front = M.project_points_c(
        px, py, pz, M.mat(view), M.mat(proj), near_plane)
    alive &= in_front
    alive &= ~M.cull_by_far_plane(depth, far_plane)
    screen_x = (nx + 1.0) * (0.5 * width)
    screen_y = (ny + 1.0) * (0.5 * height)
    alive &= opacity >= M.f32(alpha_threshold)

    c3d = M.build_covariance_3d_c(sx, sy, sz, rot[:, 0], rot[:, 1], rot[:, 2],
                                  rot[:, 3])
    if scene_transform is not None:
        rs = np.asarray(scene_transform, np.float32)[:3, :3].tolist()
        s00, s01, s02, s11, s12, s22 = c3d
        sym = [[s00, s01, s02], [s01, s11, s12], [s02, s12, s22]]
        tmp = [[sum(rs[i][k] * sym[k][j] for k in range(3)) for j in range(3)]
               for i in range(3)]

        def rotated(i, j):
            return sum(tmp[i][k] * rs[j][k] for k in range(3))

        c3d = (rotated(0, 0), rotated(0, 1), rotated(0, 2),
               rotated(1, 1), rotated(1, 2), rotated(2, 2))
    ca, cb, cd = M.project_covariance_2d_c(c3d, vx, vy, vz, M.mat(view),
                                           M.mat(proj), float(width),
                                           float(height))
    ca, cb, cd = M.stabilize_covariance_2d_c(ca, cb, cd, float(width),
                                             float(height))
    theta, sigma1, sigma2, eig_ok = M.covariance_to_theta_sigmas_c(ca, cb, cd)
    alive &= eig_ok
    alive &= ~M.cull_by_radius(3.0 * torch.maximum(sigma1, sigma2))
    det2d = ca * cd - cb * cb
    alive &= ~M.cull_by_total_ink(opacity, det2d, depth, near_plane,
                                  far_plane, total_ink_threshold)
    obb_x, obb_y = M.compute_obb_extents_c(ca, cb, cd, 3.0)
    alive &= ~M.cull_by_screen_bounds_c(screen_x, screen_y, obb_x, obb_y,
                                        float(width), float(height))

    color = M.compute_sh_color_c(gi.harmonics, px, py, pz, camera_center,
                                 sh_degree)
    color = torch.clamp(color + 0.5, min=0.0)
    if input_is_srgb:
        color = M.srgb_to_linear(color)
    record = RenderRecord(
        mean_x=screen_x.to(torch.float16), mean_y=screen_y.to(torch.float16),
        theta=M.pack_theta_u16(theta), sigma1=sigma1.to(torch.float16),
        sigma2=sigma2.to(torch.float16), depth=depth.to(torch.float16),
        color=_u8(color), opacity=_u8(opacity))

    min_tx, max_tx, min_ty, max_ty = M.compute_tile_bounds_c(
        screen_x, screen_y, obb_x, obb_y, float(width), float(height), tile_w,
        tile_h, tiles_x, tiles_y)
    alive &= (min_tx <= max_tx) & (min_ty <= max_ty)
    # the d2 cutoff of the quantized opacity: below tau nothing is drawn
    opacity_q = record.opacity.to(f32) * (1.0 / 255.0)
    tau = max(alpha_threshold, 1e-12)
    alive &= M.compute_d2_cutoff(opacity_q, tau) >= 0.0
    depth_key = torch.where(alive, M.float_to_sortable_uint(depth), M.U32)
    return ProjectionResult(record=record, visible=alive, depth_key=depth_key,
                            **_rect(alive, min_tx, max_tx, min_ty, max_ty))


def derive_blend_attributes(record: RenderRecord) -> dict:
    """Blend attributes of the quantized record, (N,) float32 each: the
    linear forms ``a1, b1, c1`` / ``a2, b2, c2`` with q = u^2 + v^2, u = a1
    px + b1 py + c1, v = a2 px + b2 py + c2 at absolute pixel coordinates;
    ``r, g, b``, ``op`` in [0, 1]; ``depth``; ``mean_x``, ``mean_y``."""
    f32 = torch.float32
    theta = M.unpack_theta_u16(record.theta)
    s1 = torch.clamp(record.sigma1.to(f32), min=1e-4)
    s2 = torch.clamp(record.sigma2.to(f32), min=1e-4)
    c = torch.cos(theta)
    s = torch.sin(theta)
    inv1 = M.rdiv(1.0, s1)
    inv2 = M.rdiv(1.0, s2)
    mx = record.mean_x.to(f32)
    my = record.mean_y.to(f32)
    color = record.color.to(f32) * (1.0 / 255.0)
    return {
        "a1": c * inv1, "b1": s * inv1, "c1": -(mx * c + my * s) * inv1,
        "a2": -s * inv2, "b2": c * inv2, "c2": (mx * s - my * c) * inv2,
        "r": color[..., 0], "g": color[..., 1], "b": color[..., 2],
        "op": record.opacity.to(f32) * (1.0 / 255.0),
        "depth": record.depth.to(f32), "mean_x": mx, "mean_y": my,
    }


@dataclasses.dataclass
class StereoProjectionResult:
    """Per-gaussian outputs of the dual-eye project+cull stage: each eye's
    quantized record, ``eye_visible`` (2, N), ``visible`` (either eye, and
    the shared culls), the union tile rect and its full ``rect_count``,
    the sortable mean-depth key, ``center_depth`` (float16) and the union
    pixel bounds (float32, clamped to the screen, 0 where culled)."""

    record_left: RenderRecord
    record_right: RenderRecord
    eye_visible: torch.Tensor
    visible: torch.Tensor
    min_tx: torch.Tensor
    max_tx: torch.Tensor
    min_ty: torch.Tensor
    max_ty: torch.Tensor
    rect_count: torch.Tensor
    depth_key: torch.Tensor
    center_depth: torch.Tensor
    px_min: torch.Tensor
    px_max: torch.Tensor
    py_min: torch.Tensor
    py_max: torch.Tensor


def _project_one_eye(px, py, pz, c3d, view, proj, width, height, tile_w,
                     tile_h, near_plane, far_plane):
    """One eye's projection chain (the covariance built once, in scene
    orientation, by the caller)."""
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    view_m, proj_m = M.mat(view), M.mat(proj)
    vx, vy, vz, nx, ny, depth, in_front = M.project_points_c(
        px, py, pz, view_m, proj_m, near_plane)
    ok = in_front & ~M.cull_by_far_plane(depth, far_plane)
    screen_x = (nx + 1.0) * (0.5 * width)
    screen_y = (ny + 1.0) * (0.5 * height)
    ca, cb, cd = M.project_covariance_2d_c(c3d, vx, vy, vz, view_m, proj_m,
                                           float(width), float(height))
    ca, cb, cd = M.stabilize_covariance_2d_c(ca, cb, cd, float(width),
                                             float(height))
    theta, sigma1, sigma2, eig_ok = M.covariance_to_theta_sigmas_c(ca, cb, cd)
    ok &= eig_ok
    ok &= ~M.cull_by_radius(3.0 * torch.maximum(sigma1, sigma2))
    obb_x, obb_y = M.compute_obb_extents_c(ca, cb, cd, 3.0)
    ok &= ~M.cull_by_screen_bounds_c(screen_x, screen_y, obb_x, obb_y,
                                     float(width), float(height))
    min_tx, max_tx, min_ty, max_ty = M.compute_tile_bounds_c(
        screen_x, screen_y, obb_x, obb_y, float(width), float(height), tile_w,
        tile_h, tiles_x, tiles_y)
    ok &= (min_tx <= max_tx) & (min_ty <= max_ty)
    return dict(screen_x=screen_x, screen_y=screen_y, depth=depth, theta=theta,
                sigma1=sigma1, sigma2=sigma2, det=ca * cd - cb * cb,
                visible=ok, min_tx=min_tx, max_tx=max_tx, min_ty=min_ty,
                max_ty=max_ty,
                px_min=torch.clamp(screen_x - obb_x, 0.0, float(width)),
                px_max=torch.clamp(screen_x + obb_x, 0.0, float(width)),
                py_min=torch.clamp(screen_y - obb_y, 0.0, float(height)),
                py_max=torch.clamp(screen_y + obb_y, 0.0, float(height)))


def stereo_project_and_cull(gi, views, projs, centers, *, width: int,
                            height: int, tile_w: int, tile_h: int,
                            sh_degree: int, near_plane: float,
                            far_plane: float, alpha_threshold: float,
                            total_ink_threshold: float, input_is_srgb: bool,
                            scene_transform=None) -> StereoProjectionResult:
    """Dual-eye projection: both eyes' records over the union tile rect,
    colour from the mid camera, the depth key of the eyes' mean depth.
    ``views`` / ``projs`` (2, 4, 4), ``centers`` (2, 3) and the optional
    ``scene_transform`` (4, 4) are host arrays."""
    f32 = torch.float32
    st = (np.eye(4, dtype=np.float32) if scene_transform is None
          else np.asarray(scene_transform, np.float32))
    sc, rot = gi.scales.to(f32), gi.rotations.to(f32)
    sx, sy, sz = sc[:, 0], sc[:, 1], sc[:, 2]
    opacity = gi.opacities.to(f32)
    shared_ok = ~M.cull_by_scale_c(sx, sy, sz)
    shared_ok &= opacity >= M.f32(alpha_threshold)
    pos = gi.positions.to(f32)
    px, py, pz, _ = M.apply_mat4_c(M.mat(st), pos[:, 0], pos[:, 1], pos[:, 2])
    col = st[:3, 0]
    scale = float(np.sqrt(col[0] * col[0] + col[1] * col[1] + col[2] * col[2]))
    c3d = M.build_covariance_3d_c(sx * scale, sy * scale, sz * scale,
                                  rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3])
    views = np.asarray(views, np.float32)
    projs = np.asarray(projs, np.float32)
    eye = [_project_one_eye(px, py, pz, c3d, views[i], projs[i], width,
                            height, tile_w, tile_h, near_plane, far_plane)
           for i in range(2)]
    vis_l = eye[0]["visible"] & shared_ok
    vis_r = eye[1]["visible"] & shared_ok
    any_vis = vis_l | vis_r
    both = vis_l & vis_r
    d_l, d_r = eye[0]["depth"], eye[1]["depth"]
    check_depth = torch.where(both, 0.5 * (d_l + d_r),
                              torch.where(vis_l, d_l, d_r))
    det = torch.where(both, torch.maximum(eye[0]["det"], eye[1]["det"]),
                      torch.where(vis_l, eye[0]["det"], eye[1]["det"]))
    any_vis &= ~M.cull_by_total_ink(opacity, det, check_depth, near_plane,
                                    far_plane, total_ink_threshold)

    c = np.asarray(centers, np.float32)
    mid = np.float32(0.5) * (c[0] + c[1])
    color = torch.clamp(M.compute_sh_color_c(gi.harmonics, px, py, pz, mid,
                                             sh_degree) + 0.5, min=0.0)
    if input_is_srgb:
        color = M.srgb_to_linear(color)
    color_u8, op_u8 = _u8(color), _u8(opacity)

    big = 1 << 20

    def pick(key, reduce_min):
        fill = big if reduce_min else -big
        a = torch.where(vis_l, eye[0][key], fill)
        b = torch.where(vis_r, eye[1][key], fill)
        return torch.minimum(a, b) if reduce_min else torch.maximum(a, b)

    min_tx, max_tx = pick("min_tx", True), pick("max_tx", False)
    min_ty, max_ty = pick("min_ty", True), pick("max_ty", False)
    bounds = {k: pick(k, k.endswith("min"))
              for k in ("px_min", "px_max", "py_min", "py_max")}
    any_vis &= (min_tx <= max_tx) & (min_ty <= max_ty)

    def eye_record(i, vis):
        # an eye that does not see the gaussian: its mean at the largest
        # finite off-screen offset, so its alpha underflows to exactly 0
        def safe_mean(coord):
            return torch.where(vis, coord, -6e4).to(torch.float16)

        e = eye[i]
        return RenderRecord(
            mean_x=safe_mean(e["screen_x"]), mean_y=safe_mean(e["screen_y"]),
            theta=M.pack_theta_u16(torch.where(vis, e["theta"], 0.0)),
            sigma1=torch.where(vis, e["sigma1"], 1.0).to(torch.float16),
            sigma2=torch.where(vis, e["sigma2"], 1.0).to(torch.float16),
            depth=torch.where(vis, e["depth"], 0.0).to(torch.float16),
            color=color_u8, opacity=op_u8)

    return StereoProjectionResult(
        record_left=eye_record(0, vis_l), record_right=eye_record(1, vis_r),
        eye_visible=torch.stack([vis_l, vis_r]), visible=any_vis,
        depth_key=torch.where(any_vis, M.float_to_sortable_uint(check_depth),
                              M.U32),
        center_depth=check_depth.to(torch.float16),
        **_rect(any_vis, min_tx, max_tx, min_ty, max_ty),
        **{k: torch.where(any_vis, v, 0.0).to(f32) for k, v in bounds.items()})
