"""Scene datasets and synthetic scene generators (numpy).

Copies of ``gsm_renderer_tpu/io/scene.py``'s ``GaussianDataset``,
``generate_grid_gaussians`` and ``generate_visible_gaussians``, so that the
same seed gives the same scene in both packages; ``to_input`` builds a
PyTorch :class:`GaussianInput` on a device (the card by default).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import Precision, sh_components
from ..types import GaussianInput, make_gaussian_input


@dataclasses.dataclass
class GaussianDataset:
    """Host-side scene container."""

    positions: np.ndarray   # (N, 3) f32
    scales: np.ndarray      # (N, 3) f32 (linear, not log)
    rotations: np.ndarray   # (N, 4) f32 quaternion (x, y, z, w)
    opacities: np.ndarray   # (N,) f32 in [0, 1]
    harmonics: np.ndarray   # (N, n_coeffs, 3) f32

    @property
    def count(self) -> int:
        return self.positions.shape[0]

    def bounds(self):
        return self.positions.min(0), self.positions.max(0)

    def centroid(self):
        return self.positions.mean(0)

    def to_input(self, precision: Precision = Precision.FLOAT32,
                 device=None) -> GaussianInput:
        return make_gaussian_input(self.positions, self.scales, self.rotations,
                                   self.opacities, self.harmonics, precision,
                                   device=device)


def generate_grid_gaussians(count: int, sh_degree: int = 0, seed: int = 42,
                            z_range=(2.0, 6.0), xy_extent: float = 2.0,
                            scale_range=(0.02, 0.08)) -> GaussianDataset:
    """Seeded grid of gaussians in front of an identity OpenCV camera (+Z)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(count)))
    ix = np.arange(count) % side
    iy = np.arange(count) // side
    x = (ix / max(side - 1, 1) - 0.5) * 2 * xy_extent
    y = (iy / max(side - 1, 1) - 0.5) * 2 * xy_extent
    z = rng.uniform(*z_range, count)
    positions = np.stack([x, y, z], -1).astype(np.float32)

    scales = rng.uniform(*scale_range, (count, 3)).astype(np.float32)
    quats = rng.normal(size=(count, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.uniform(0.4, 1.0, count).astype(np.float32)

    n_coeffs = sh_components(sh_degree)
    harmonics = np.zeros((count, n_coeffs, 3), np.float32)
    harmonics[:, 0, :] = (rng.uniform(0.1, 0.9, (count, 3)) - 0.5) / 0.28209479
    if n_coeffs > 1:
        harmonics[:, 1:, :] = rng.normal(0, 0.05, (count, n_coeffs - 1, 3))
    return GaussianDataset(positions, scales, quats, opacities,
                           harmonics.astype(np.float32))


def generate_visible_gaussians(count: int, sh_degree: int = 0, seed: int = 7,
                               spread: float = 1.5,
                               scale_range=(0.01, 0.12)) -> GaussianDataset:
    """Random cloud inside the view frustum of the default test camera."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.5, 8.0, count)
    lim = 0.55 * np.tan(np.radians(30.0)) * z
    x = rng.uniform(-1, 1, count) * lim * spread / 1.5
    y = rng.uniform(-1, 1, count) * lim * spread / 1.5
    positions = np.stack([x, y, z], -1).astype(np.float32)
    scales = rng.uniform(*scale_range, (count, 3)).astype(np.float32)
    quats = rng.normal(size=(count, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.uniform(0.2, 1.0, count).astype(np.float32)
    n_coeffs = sh_components(sh_degree)
    harmonics = np.zeros((count, n_coeffs, 3), np.float32)
    harmonics[:, 0, :] = (rng.uniform(0.0, 1.0, (count, 3)) - 0.5) / 0.28209479
    if n_coeffs > 1:
        harmonics[:, 1:, :] = rng.normal(0, 0.08, (count, n_coeffs - 1, 3))
    return GaussianDataset(positions, scales, quats, opacities,
                           harmonics.astype(np.float32))
