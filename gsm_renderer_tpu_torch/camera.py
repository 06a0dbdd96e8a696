"""Camera parameters (mono and stereo) and projection-matrix helpers.

PyTorch counterpart of ``gsm_renderer_tpu/camera.py``.  Matrices follow
``clip = proj @ view @ [x, y, z, 1]^T``; both the OpenCV (+Z forward) and the
OpenGL (-Z forward) conventions are supported.  The matrices stay host numpy
arrays: the kernels take them as launch arguments, so a frame uploads nothing.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class CameraParams:
    """Per-eye camera: (4, 4) float32 view/projection matrices, the
    world-space camera center (for the SH view direction), and metadata."""

    view_matrix: np.ndarray
    projection_matrix: np.ndarray
    position: np.ndarray  # (3,)
    focal_x: float = 0.0
    focal_y: float = 0.0
    near_plane: float = 0.1
    far_plane: float = 100.0

    def to_tensors(self, device):
        """(view, proj, position) as float32 tensors on ``device``."""
        return tuple(torch.as_tensor(np.asarray(m, np.float32), device=device)
                     for m in (self.view_matrix, self.projection_matrix,
                               self.position))


@dataclasses.dataclass
class StereoCameraParams:
    """Dual-eye camera: the left and right eyes and an optional (4, 4)
    world -> scene transform (identity when None), all host arrays."""

    left: CameraParams
    right: CameraParams
    scene_transform: np.ndarray | None = None


def make_projection_matrix(width: int, height: int, near: float = 0.1,
                           far: float = 10.0, fov_degrees: float = 60.0,
                           convention: str = "opencv") -> np.ndarray:
    """Perspective projection (Metal NDC with z in [0, 1])."""
    aspect = width / height
    f = 1.0 / math.tan(math.radians(fov_degrees) / 2.0)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    if convention == "opencv":
        proj[2, 2] = far / (far - near)
        proj[2, 3] = -(far * near) / (far - near)
        proj[3, 2] = 1.0
    elif convention == "opengl":
        proj[2, 2] = far / (near - far)
        proj[2, 3] = (far * near) / (near - far)
        proj[3, 2] = -1.0
    else:
        raise ValueError(f"unknown convention {convention!r}")
    return proj


def make_look_at(eye, target, up=(0.0, 1.0, 0.0),
                 convention: str = "opencv") -> np.ndarray:
    """View matrix looking from ``eye`` toward ``target``."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    zaxis = fwd if convention == "opencv" else -fwd
    xaxis = np.cross(up, zaxis)
    n = np.linalg.norm(xaxis)
    xaxis = np.array([1.0, 0.0, 0.0]) if n < 1e-8 else xaxis / n
    yaxis = np.cross(zaxis, xaxis)
    view = np.eye(4, dtype=np.float64)
    view[0, :3] = xaxis
    view[1, :3] = yaxis
    view[2, :3] = zaxis
    view[:3, 3] = -view[:3, :3] @ eye
    return view.astype(np.float32)


def make_camera(width: int, height: int, position=(0.0, 0.0, 0.0),
                view_matrix: np.ndarray | None = None, near: float = 0.1,
                far: float = 10.0, fov_degrees: float = 60.0,
                convention: str = "opencv") -> CameraParams:
    """CameraParams factory with the JAX package's defaults."""
    if view_matrix is None:
        view_matrix = np.eye(4, dtype=np.float32)
    aspect = width / height
    f = 1.0 / math.tan(math.radians(fov_degrees) / 2.0)
    proj = make_projection_matrix(width, height, near, far, fov_degrees, convention)
    return CameraParams(
        view_matrix=np.asarray(view_matrix, np.float32),
        projection_matrix=proj,
        position=np.asarray(position, np.float32),
        focal_x=width * f / (2 * aspect),
        focal_y=height * f / 2,
        near_plane=near,
        far_plane=far,
    )


def make_side_by_side_stereo(camera: CameraParams,
                             ipd: float = 0.063) -> StereoCameraParams:
    """A side-by-side stereo rig from a mono camera: the eyes shifted by
    -+ipd/2 along the view-space X axis."""
    view = np.asarray(camera.view_matrix, np.float32)
    shift_l = np.eye(4, dtype=np.float32)
    shift_l[0, 3] = ipd / 2.0
    shift_r = np.eye(4, dtype=np.float32)
    shift_r[0, 3] = -ipd / 2.0
    rot = view[:3, :3]
    base_pos = -rot.T @ view[:3, 3]
    right_axis = rot.T @ np.array([1.0, 0.0, 0.0], np.float32)
    left = dataclasses.replace(
        camera, view_matrix=shift_l @ view,
        position=(base_pos - right_axis * (ipd / 2.0)).astype(np.float32))
    right = dataclasses.replace(
        camera, view_matrix=shift_r @ view,
        position=(base_pos + right_axis * (ipd / 2.0)).astype(np.float32))
    return StereoCameraParams(left=left, right=right)
