from .base import GaussianRenderer
from .depth_first import DepthFirstRenderer
from .global_ import GlobalRenderer
from .hardware import HardwareRenderer
from .local import LocalRenderer

__all__ = ["GaussianRenderer", "DepthFirstRenderer", "GlobalRenderer",
           "HardwareRenderer", "LocalRenderer"]
