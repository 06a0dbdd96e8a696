"""span_rebin_ms: device ms a traced frame of the foveated frame's re-bin
onto the physical tiles (``gsm::rebin``), from the renderer's span markers on
the stream."""

from gsmbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "rebin")
