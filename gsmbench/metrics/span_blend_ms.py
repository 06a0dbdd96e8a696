"""span_blend_ms: device ms a traced frame of the blend (``gsm::blend``:
blend and assemble), from the renderer's span markers on the stream."""

from gsmbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "blend")
