"""project_roofline: the projection's bound (harness/roofline.py: every
input gaussian read once in its input layout, one record written a visible
gaussian of the reference) over its device time, in %."""

from gsmbench.harness import roofline
from gsmbench.harness.layers import share


def read(ctx):
    cfg = ctx["config"]
    return share(ctx, "project", lambda c: roofline.project(
        c["counts"], cfg["scene"]["sh_degree"], cfg["precision"]))
