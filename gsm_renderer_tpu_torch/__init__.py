"""gsm_renderer_tpu_torch: the PyTorch / CUDA port of gsm_renderer_tpu.

The JAX package ``gsm_renderer_tpu`` is the reference; this package renders
the same frames with PyTorch and hand-written CUDA kernels for the H100
(``csrc/``, built on first use).  Entry points run on the card unless the
caller passes ``device="cpu"``, which runs the plain PyTorch versions of the
kernels.  Importing the package imports neither JAX nor the JAX package.
"""

from .camera import CameraParams, make_camera, make_look_at, make_projection_matrix
from .config import (ColorFormat, DepthSortKeyPrecision, GaussianColorSpace,
                     HardwareBackend, Precision, RendererConfig, TileIdPrecision)
from .interop import camera_from_numpy, gaussian_input_from_numpy
from .pipelines import (DepthFirstRenderer, GaussianRenderer, GlobalRenderer,
                        HardwareRenderer, LocalRenderer)
from .types import (FrameHeader, GaussianInput, RendererError, RenderOutput,
                    make_gaussian_input)

__version__ = "0.1.0"

__all__ = [
    "CameraParams", "make_camera", "make_look_at", "make_projection_matrix",
    "ColorFormat", "DepthSortKeyPrecision", "GaussianColorSpace",
    "HardwareBackend", "Precision", "RendererConfig", "TileIdPrecision",
    "camera_from_numpy", "gaussian_input_from_numpy",
    "DepthFirstRenderer", "GaussianRenderer", "GlobalRenderer",
    "HardwareRenderer", "LocalRenderer",
    "FrameHeader", "GaussianInput", "RendererError", "RenderOutput",
    "make_gaussian_input",
]
