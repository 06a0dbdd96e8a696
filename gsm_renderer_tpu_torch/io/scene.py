"""Scene datasets and synthetic scene generators (numpy).

Copies of ``gsm_renderer_tpu/io/scene.py``'s ``GaussianDataset``, the
Morton sort (native where the helper builds, as in JAX) and the generators
(``generate_grid_gaussians``, ``generate_visible_gaussians``,
``generate_realistic_gaussians``), so that the same seed gives the same
scene in both packages; ``to_input`` builds a PyTorch
:class:`GaussianInput` on a device (the card by default).
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


# --- Morton spatial sort -----------------------------------------------------------

def _expand_bits_21(v: np.ndarray) -> np.ndarray:
    """Interleave 21-bit integers with two zero bits between each bit."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_codes(positions: np.ndarray) -> np.ndarray:
    """63-bit Morton codes, 21 bits per axis over the scene AABB, quantized
    in float32 as the JAX package's native helper does
    (``native/gsm_native.cpp::morton_sort_indices``): t = (p - lo) * ((2^21
    - 1) / extent), clamped, truncated."""
    pos = np.asarray(positions, np.float32)
    lo = pos.min(0)
    extent = np.maximum(pos.max(0) - lo, np.float32(1e-12))
    top = np.float32((1 << 21) - 1)
    t = np.clip((pos - lo) * (top / extent), np.float32(0.0), top)
    q = t.astype(np.uint64)
    return (_expand_bits_21(q[:, 0])
            | (_expand_bits_21(q[:, 1]) << np.uint64(1))
            | (_expand_bits_21(q[:, 2]) << np.uint64(2)))


def sort_by_morton(ds: GaussianDataset) -> GaussianDataset:
    """Spatial cache-locality sort: the native helper's Morton argsort
    (``native/gsm_native.cpp``) where the library builds, else a stable
    argsort of :func:`morton_codes`, which gives the same order."""
    from ..native import morton_sort_indices
    order = morton_sort_indices(ds.positions)
    if order is None:
        order = np.argsort(morton_codes(ds.positions), kind="stable")
    return GaussianDataset(
        positions=ds.positions[order], scales=ds.scales[order],
        rotations=ds.rotations[order], opacities=ds.opacities[order],
        harmonics=ds.harmonics[order])


# --- Synthetic scenes --------------------------------------------------------------

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


def generate_realistic_gaussians(count: int, sh_degree: int = 3,
                                 seed: int = 11) -> GaussianDataset:
    """Heavy-tailed synthetic scene with the statistics of trained 3DGS
    assets: surface-clustered positions (a ground plane, blobby objects, a
    sparse far background shell), log-normal scales with surfel-like
    anisotropy, bimodal opacity, Morton-sorted.  The large background splats
    give the oversized tile rects that the row decomposition narrows."""
    rng = np.random.default_rng(seed)
    n_ground = int(count * 0.35)
    n_obj = int(count * 0.45)
    n_bg = count - n_ground - n_obj

    gx = rng.uniform(-6, 6, n_ground)
    gz = rng.uniform(1.0, 14.0, n_ground)
    gy = -1.0 + rng.normal(0, 0.03, n_ground)
    ground = np.stack([gx, gy, gz], -1)

    n_blobs = 12
    centers = np.stack([rng.uniform(-3, 3, n_blobs),
                        rng.uniform(-0.8, 1.2, n_blobs),
                        rng.uniform(2.0, 10.0, n_blobs)], -1)
    radii = rng.uniform(0.25, 0.9, n_blobs)
    which = rng.integers(0, n_blobs, n_obj)
    dirs = rng.normal(size=(n_obj, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    r = radii[which] * (0.85 + 0.15 * rng.random(n_obj))
    objs = centers[which] + dirs * r[:, None]

    bdir = rng.normal(size=(n_bg, 3))
    bdir[:, 2] = np.abs(bdir[:, 2]) + 0.4
    bdir /= np.linalg.norm(bdir, axis=-1, keepdims=True)
    bg = bdir * rng.uniform(15.0, 30.0, n_bg)[:, None]

    positions = np.concatenate([ground, objs, bg]).astype(np.float32)

    base = np.exp(rng.normal(np.log(0.012), 0.9, count))
    base[n_ground + n_obj:] *= 6.0
    base = np.clip(base, 1e-4, 2.5)
    aniso = np.stack([np.ones(count),
                      np.exp(rng.normal(0, 0.35, count)),
                      np.exp(rng.normal(-1.6, 0.5, count))], -1)
    scales = (base[:, None] * aniso).astype(np.float32)

    quats = rng.normal(size=(count, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)

    solid = rng.random(count) < 0.55
    opacities = np.where(solid, rng.uniform(0.65, 1.0, count),
                         rng.beta(1.2, 4.0, count)).astype(np.float32)

    n_coeffs = sh_components(sh_degree)
    harmonics = np.zeros((count, n_coeffs, 3), np.float32)
    harmonics[:, 0, :] = (rng.uniform(0.05, 0.95, (count, 3)) - 0.5) / 0.28209479
    if n_coeffs > 1:
        harmonics[:, 1:, :] = rng.normal(0, 0.06, (count, n_coeffs - 1, 3))
    ds = GaussianDataset(positions, scales, quats, opacities,
                         harmonics.astype(np.float32))
    return sort_by_morton(ds)
