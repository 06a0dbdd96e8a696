"""span_binning_ms: device ms a traced frame of the binning
(``gsm::binning``: prep, the row expand, the expand and the glue between
them), from the renderer's span markers on the stream."""

from gsmbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "binning")
