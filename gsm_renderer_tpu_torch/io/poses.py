"""Camera-pose sidecar parsing.

Port of ``gsm_renderer_tpu/io/poses.py`` (the same NumPy code).  Real 3DGS
assets ship their training poses beside the PLY.  Supported formats:

* **INRIA / gaussian-splatting ``cameras.json``** — a list of
  ``{id, img_name, width, height, position, rotation (3x3 C2W), fx, fy}``,
* **nerfstudio ``transforms.json``** — ``{fl_x, fl_y, w, h, frames: [...]}}``
  with per-frame 4x4 ``transform_matrix`` (C2W, OpenGL axes).

Both decode to lists of the port's :class:`~..camera.CameraParams`, whose
matrices are host numpy arrays (OpenCV convention: +Z forward, y down).
"""

from __future__ import annotations

import json

import numpy as np

from ..camera import CameraParams


def _params_from_c2w(rot_c2w, center, fx, fy, width, height, near, far):
    rot = np.asarray(rot_c2w, np.float64)
    center = np.asarray(center, np.float64)
    view = np.eye(4, dtype=np.float64)
    view[:3, :3] = rot.T               # world -> camera
    view[:3, 3] = -rot.T @ center
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 2.0 * fx / width
    proj[1, 1] = 2.0 * fy / height
    proj[2, 2] = far / (far - near)
    proj[2, 3] = -(far * near) / (far - near)
    proj[3, 2] = 1.0
    return CameraParams(
        view_matrix=view.astype(np.float32),
        projection_matrix=proj,
        position=center.astype(np.float32),
        focal_x=float(fx), focal_y=float(fy),
        near_plane=float(near), far_plane=float(far),
    )


def load_cameras_json(path_or_str, near: float = 0.01, far: float = 100.0):
    """INRIA ``cameras.json`` -> list of (CameraParams, width, height, name)."""
    if isinstance(path_or_str, (str, bytes)) and not str(path_or_str).lstrip().startswith("["):
        with open(path_or_str) as f:
            entries = json.load(f)
    else:
        entries = json.loads(path_or_str)
    out = []
    for e in entries:
        cam = _params_from_c2w(e["rotation"], e["position"], e["fx"], e["fy"],
                               e["width"], e["height"], near, far)
        out.append((cam, int(e["width"]), int(e["height"]),
                    e.get("img_name", str(e.get("id", "")))))
    return out


# OpenGL camera axes (nerfstudio) -> OpenCV: flip y and z
_GL_TO_CV = np.diag([1.0, -1.0, -1.0])


def load_transforms_json(path_or_str, near: float = 0.01, far: float = 100.0):
    """nerfstudio ``transforms.json`` -> list of (CameraParams, w, h, name)."""
    if isinstance(path_or_str, (str, bytes)) and not str(path_or_str).lstrip().startswith("{"):
        with open(path_or_str) as f:
            meta = json.load(f)
    else:
        meta = json.loads(path_or_str)
    out = []
    for fr in meta.get("frames", []):
        m = np.asarray(fr["transform_matrix"], np.float64)
        rot_c2w = m[:3, :3] @ _GL_TO_CV
        center = m[:3, 3]
        fx = fr.get("fl_x", meta.get("fl_x"))
        fy = fr.get("fl_y", meta.get("fl_y", fx))
        w = int(fr.get("w", meta.get("w")))
        h = int(fr.get("h", meta.get("h")))
        cam = _params_from_c2w(rot_c2w, center, fx, fy, w, h, near, far)
        out.append((cam, w, h, fr.get("file_path", "")))
    return out
