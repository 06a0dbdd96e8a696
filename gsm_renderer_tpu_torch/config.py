"""Renderer configuration.

PyTorch counterpart of ``gsm_renderer_tpu/config.py``: the same enums, field
names and defaults, so a configuration means the same thing in both packages.
Options this package does not implement yet are rejected where they are used
(``pipelines/depth_first.py``), never silently changed here.
"""

from __future__ import annotations

import dataclasses
import enum


class Precision(enum.Enum):
    """World-gaussian input precision (48-byte float32 or 32-byte float16
    layouts of the reference)."""

    FLOAT32 = "float32"
    FLOAT16 = "float16"


class GaussianColorSpace(enum.Enum):
    """Color space of the SH-decoded gaussian color."""

    LINEAR = "linear"
    SRGB = "srgb"


class ColorFormat(enum.Enum):
    """Render-target texel format.  ``RGBA16_FLOAT`` returns float16 color
    and depth (the blend still accumulates in float32); ``RGBA32_FLOAT``
    returns float32."""

    RGBA16_FLOAT = "rgba16Float"
    RGBA32_FLOAT = "rgba32Float"


class DepthSortKeyPrecision(enum.Enum):
    """Depth sort-key width."""

    BITS16 = 16
    BITS32 = 32


class TileIdPrecision(enum.Enum):
    """Instance tile-id width."""

    BITS16 = 16
    BITS32 = 32


class HardwareBackend(enum.Enum):
    """Hardware-renderer backend selector (kept for configuration parity)."""

    MESH_SHADERS = "meshShaders"
    INSTANCED = "instanced"


DEFAULT_ALPHA_THRESHOLD = 0.005
DEFAULT_TOTAL_INK_THRESHOLD = 2.0
LOCAL_MAX_PER_TILE = 2048

#: instance capacity = 4 x gaussians (the reference's model; exact-tested
#: instance counts make it sufficient)
INSTANCE_CAPACITY_FACTOR = 4
FULL_RECT_CAPACITY_FACTOR = 8


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Static renderer configuration; defaults equal the JAX package's."""

    max_gaussians: int = 6_000_000
    max_width: int = 1920
    max_height: int = 1080
    precision: Precision = Precision.FLOAT16
    gaussian_color_space: GaussianColorSpace = GaussianColorSpace.LINEAR
    color_format: ColorFormat = ColorFormat.RGBA32_FLOAT
    back_to_front: bool = False

    sh_degree: int = 3
    alpha_threshold: float = DEFAULT_ALPHA_THRESHOLD
    total_ink_threshold: float = DEFAULT_TOTAL_INK_THRESHOLD
    depth_sort_key_precision: DepthSortKeyPrecision = DepthSortKeyPrecision.BITS32
    tile_id_precision: TileIdPrecision = TileIdPrecision.BITS16
    hardware_backend: HardwareBackend = HardwareBackend.MESH_SHADERS

    #: static instance capacity; 0 = INSTANCE_CAPACITY_FACTOR x gaussians
    max_instances: int = 0

    #: per-row exact-span decomposition of oversized rects (the row-expand
    #: kernel, mono frames).  Output is bitwise identical either way; only the
    #: slot volume changes.
    row_expand: bool = True

    #: optional depth output; False drops the depth plane and
    #: ``RenderOutput.depth`` is None
    depth_output: bool = True

    foveated_lod: float = 0.0

    def __post_init__(self):
        if not (0 <= self.sh_degree <= 3):
            raise ValueError(f"sh_degree must be in [0, 3], got {self.sh_degree}")
        if self.max_gaussians <= 0 or self.max_width <= 0 or self.max_height <= 0:
            raise ValueError("max_gaussians/max_width/max_height must be positive")


def sh_components(sh_degree: int) -> int:
    """Number of SH coefficients per channel for a degree (1, 4, 9 or 16)."""
    return (sh_degree + 1) ** 2


def tiles_for(width: int, height: int, tile_w: int, tile_h: int) -> tuple[int, int]:
    """Tile grid dimensions covering a ``width`` x ``height`` surface."""
    return (-(-width // tile_w), -(-height // tile_h))


GLOBAL_TILE = (32, 16)  # (w, h)
LOCAL_TILE = (16, 16)
DEPTH_FIRST_TILE = (16, 16)
