"""span_header_ms: device ms a traced frame of the frame header's sums
(``gsm::header``), from the renderer's span markers on the stream."""

from gsmbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "header")
