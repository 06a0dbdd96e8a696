"""binning_roofline: the binning's bound (harness/roofline.py: the
reference's visible records read once, a key and an entry word written for
each pair its exact tile test keeps) over its device time, in %."""

from gsmbench.harness import roofline
from gsmbench.harness.layers import share


def read(ctx):
    return share(ctx, "binning", lambda c: roofline.binning(c["counts"]))
