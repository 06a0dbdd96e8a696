"""binning_ms: device ms a frame of the binning layer's kernels (harness/trace.py's
LAYER_KERNELS), from the traced frames."""

from gsmbench.harness.layers import ms


def read(ctx):
    return ms(ctx, "binning")
