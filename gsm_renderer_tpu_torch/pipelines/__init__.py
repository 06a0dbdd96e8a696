from .base import GaussianRenderer
from .depth_first import DepthFirstRenderer, HardwareRenderer
from .global_ import GlobalRenderer
from .local import LocalRenderer

__all__ = ["GaussianRenderer", "DepthFirstRenderer", "GlobalRenderer",
           "HardwareRenderer", "LocalRenderer"]
