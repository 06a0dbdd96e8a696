from .base import GaussianRenderer
from .depth_first import (DepthFirstRenderer, GlobalRenderer, HardwareRenderer,
                          LocalRenderer)

__all__ = ["GaussianRenderer", "DepthFirstRenderer", "GlobalRenderer",
           "HardwareRenderer", "LocalRenderer"]
