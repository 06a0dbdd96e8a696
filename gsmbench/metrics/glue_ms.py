"""glue_ms: device ms a frame of the glue layer's kernels (harness/trace.py's
LAYER_KERNELS), from the traced frames."""

from gsmbench.harness.layers import ms


def read(ctx):
    return ms(ctx, "glue")
