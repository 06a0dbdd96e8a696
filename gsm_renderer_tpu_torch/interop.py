"""Carrying a scene and a camera across from the JAX package.

The renderer has no weights: a scene (the gaussians) and a camera are its
whole state.  These functions take them as numpy arrays, the form in which
any JAX ``GaussianInput`` / ``CameraParams`` hands them over
(``np.asarray(gi.positions)`` etc.), and build this package's objects
without changing a bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import CameraParams, StereoCameraParams
from .types import GaussianInput, resolve_device


def gaussian_input_from_numpy(positions, scales, rotations, opacities,
                              harmonics_planar, device=None) -> GaussianInput:
    """A GaussianInput from numpy arrays in the JAX layout: positions (N, 3)
    float32; scales (N, 3), rotations (N, 4), opacities (N,) and
    channel-planar harmonics (3, n_coeffs, N), all float32 or all float16.
    Values and dtypes are kept exactly."""
    dev = resolve_device(device)
    dtypes = {np.dtype(np.float32), np.dtype(np.float16)}
    arrays = [np.asarray(a) for a in (scales, rotations, opacities,
                                      harmonics_planar)]
    if any(a.dtype not in dtypes for a in arrays) or len(
            {a.dtype for a in arrays}) != 1:
        raise ValueError("scales/rotations/opacities/harmonics must share one "
                         "dtype, float32 or float16")

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    gi = GaussianInput(positions=put(np.asarray(positions, np.float32)),
                       scales=put(arrays[0]), rotations=put(arrays[1]),
                       opacities=put(arrays[2]), harmonics=put(arrays[3]))
    gi.validate()
    return gi


def camera_from_numpy(view, proj, position, near: float, far: float,
                      width: int, height: int) -> CameraParams:
    """CameraParams from (4, 4) view and projection matrices, the camera
    position and the clip planes; the focal lengths are derived from the
    projection as the JAX ``make_camera`` derives them."""
    proj = np.asarray(proj, np.float32)
    return CameraParams(
        view_matrix=np.asarray(view, np.float32), projection_matrix=proj,
        position=np.asarray(position, np.float32),
        focal_x=float(width) * abs(float(proj[0, 0])) / 2.0,
        focal_y=float(height) * abs(float(proj[1, 1])) / 2.0,
        near_plane=float(near), far_plane=float(far))


def stereo_camera_from_numpy(views, projs, positions, near: float, far: float,
                             width: int, height: int,
                             scene_transform=None) -> StereoCameraParams:
    """StereoCameraParams from (2, 4, 4) view and projection matrices, the
    (2, 3) eye positions (left first), the clip planes and an optional
    (4, 4) scene transform."""
    left, right = (camera_from_numpy(views[e], projs[e], positions[e], near,
                                     far, width, height) for e in range(2))
    st = (None if scene_transform is None
          else np.asarray(scene_transform, np.float32))
    return StereoCameraParams(left=left, right=right, scene_transform=st)
