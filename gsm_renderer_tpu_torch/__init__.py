"""gsm_renderer_tpu_torch: the PyTorch / CUDA port of gsm_renderer_tpu.

The JAX package ``gsm_renderer_tpu`` is the reference; this package renders
the same frames with PyTorch and hand-written CUDA kernels for the H100
(``csrc/``, built on first use).  Entry points run on the card unless the
caller passes ``device="cpu"``, which runs the plain PyTorch versions of the
kernels.  Importing the package imports neither JAX nor the JAX package.
"""

from .camera import (CameraParams, StereoCameraParams, make_camera, make_look_at,
                     make_projection_matrix, make_side_by_side_stereo)
from .config import (ColorFormat, DepthSortKeyPrecision, GaussianColorSpace,
                     HardwareBackend, Precision, RendererConfig, TileIdPrecision)
from .interop import (camera_from_numpy, gaussian_input_from_numpy,
                      stereo_camera_from_numpy)
from .pipelines import (DepthFirstRenderer, GaussianRenderer, GlobalRenderer,
                        HardwareRenderer, LocalRenderer)
from .stereo import (FoveatedStereoTarget, compress_foveated, expand_foveated,
                     foveated_raster_tables, make_rate_maps, warp_tables)
from .types import (FrameHeader, GaussianInput, RendererError, RenderOutput,
                    make_gaussian_input, pack_world_gaussians,
                    unpack_world_gaussians)

__version__ = "0.1.0"

__all__ = [
    "CameraParams", "StereoCameraParams", "make_camera", "make_look_at",
    "make_projection_matrix", "make_side_by_side_stereo",
    "ColorFormat", "DepthSortKeyPrecision", "GaussianColorSpace",
    "HardwareBackend", "Precision", "RendererConfig", "TileIdPrecision",
    "camera_from_numpy", "gaussian_input_from_numpy",
    "stereo_camera_from_numpy",
    "DepthFirstRenderer", "GaussianRenderer", "GlobalRenderer",
    "HardwareRenderer", "LocalRenderer",
    "FoveatedStereoTarget", "compress_foveated", "expand_foveated",
    "foveated_raster_tables", "make_rate_maps", "warp_tables",
    "FrameHeader", "GaussianInput", "RendererError", "RenderOutput",
    "make_gaussian_input", "pack_world_gaussians", "unpack_world_gaussians",
]
