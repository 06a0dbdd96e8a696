"""The antimatter15 ``.splat`` interchange format.

Port of ``gsm_renderer_tpu/io/splat.py`` (the same NumPy code), returning
the port's :class:`~.scene.GaussianDataset`.

32 bytes per splat, little-endian:
  position  3 x f32   world position
  scale     3 x f32   LINEAR scale (exp already applied)
  color     4 x u8    RGBA: rgb = 0.5 + SH_C0 * f_dc (clamped), a = opacity
  rotation  4 x u8    normalized quaternion (w, x, y, z) * 128 + 128

A widely used companion format of 3DGS assets beside PLY.
"""

from __future__ import annotations

import numpy as np

from .scene import GaussianDataset

SH_C0 = 0.28209479177387814

_DTYPE = np.dtype([
    ("position", "<f4", 3),
    ("scale", "<f4", 3),
    ("color", "u1", 4),
    ("rot", "u1", 4),
])


def load_splat(path_or_bytes) -> GaussianDataset:
    """Load a .splat buffer into a GaussianDataset (SH degree 0)."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        data = np.fromfile(path_or_bytes, dtype=np.uint8).tobytes()
    if len(data) % _DTYPE.itemsize:
        raise ValueError(f".splat size {len(data)} is not a multiple of 32")
    rec = np.frombuffer(data, dtype=_DTYPE)
    n = rec.shape[0]

    positions = rec["position"].astype(np.float32)
    scales = rec["scale"].astype(np.float32)
    rgba = rec["color"].astype(np.float32) / 255.0
    opacities = rgba[:, 3].copy()
    harmonics = np.zeros((n, 1, 3), np.float32)
    harmonics[:, 0, :] = (rgba[:, :3] - 0.5) / SH_C0

    # (w, x, y, z) u8 -> normalized (x, y, z, w)
    q = (rec["rot"].astype(np.float32) - 128.0) / 128.0
    norm = np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    q = q / norm
    rotations = np.stack([q[:, 1], q[:, 2], q[:, 3], q[:, 0]], -1)

    return GaussianDataset(positions=positions, scales=scales,
                           rotations=rotations.astype(np.float32),
                           opacities=opacities, harmonics=harmonics)


def write_splat(ds: GaussianDataset, path=None) -> bytes:
    """Encode a GaussianDataset as .splat bytes (DC color only)."""
    n = ds.count
    rec = np.zeros(n, _DTYPE)
    rec["position"] = ds.positions.astype(np.float32)
    rec["scale"] = ds.scales.astype(np.float32)
    rgb = np.clip(0.5 + SH_C0 * ds.harmonics[:, 0, :], 0.0, 1.0)
    rec["color"][:, :3] = np.round(rgb * 255.0).astype(np.uint8)
    rec["color"][:, 3] = np.round(
        np.clip(ds.opacities, 0.0, 1.0) * 255.0).astype(np.uint8)
    # (x, y, z, w) -> stored (w, x, y, z)
    q = ds.rotations / np.maximum(
        np.linalg.norm(ds.rotations, axis=-1, keepdims=True), 1e-12)
    wxyz = np.stack([q[:, 3], q[:, 0], q[:, 1], q[:, 2]], -1)
    rec["rot"] = np.clip(np.round(wxyz * 128.0 + 128.0), 0, 255).astype(np.uint8)

    out = rec.tobytes()
    if path is not None:
        if hasattr(path, "write"):
            path.write(out)
        else:
            with open(path, "wb") as f:
                f.write(out)
    return out
