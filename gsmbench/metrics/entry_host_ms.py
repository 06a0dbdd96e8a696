"""entry_host_ms: host ms a traced frame from the renderer's ``gsm::frame``
span to its ``gsm::project`` span (validation, the capacity picks and their
host reads, the projection-input cache, the frame function's preamble): the
program's own work before its first kernel."""

from gsmbench.metrics._spans import mean


def read(ctx):
    return mean(ctx, lambda f: f["entry_ms"] or 0.0)
