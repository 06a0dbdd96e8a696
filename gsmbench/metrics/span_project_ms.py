"""span_project_ms: device ms a traced frame of the projection
(``gsm::project``: kernel 1 and the copies of its wrapper), from the
renderer's span markers on the stream."""

from gsmbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "project")
