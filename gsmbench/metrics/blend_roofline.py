"""blend_roofline: the blend's bound (harness/roofline.py: the reference's
composites before each pixel's own exit whose alpha reaches the threshold,
each such record read once a tile, the image written once) over its device
time, in %."""

from gsmbench.harness import roofline
from gsmbench.harness.layers import share


def read(ctx):
    return share(ctx, "blend", lambda c: roofline.blend(c["counts"]))
