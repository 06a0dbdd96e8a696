"""Shared arithmetic of the readers of the renderer's own spans and counters
(``gsm_renderer_tpu_torch.profiling``).  The spans record while the profiler
runs, so the renderer keeps the frames of the ``--trace 1`` window; a
renderer without them gives nothing to read (None), a window that recorded
no frame 0.0."""


def traced_frames(ctx):
    """The renderer's records of the traced frames (the last
    ``trace["frames"]`` it kept); None where the renderer records none."""
    from gsm_renderer_tpu_torch import profiling

    frames = getattr(profiling, "frames", None)
    if frames is None:
        return None
    return frames()[-ctx["trace"]["frames"]:]


def mean(ctx, value):
    """Mean of ``value(frame)`` over the traced frames."""
    frames = traced_frames(ctx)
    if frames is None:
        return None
    return sum(value(f) for f in frames) / len(frames) if frames else 0.0


def stage_ms(ctx, *names):
    """Device ms a frame of the spans named ``names``, their children
    included."""
    return mean(ctx, lambda f: sum(s["device_ms"] for s in f["spans"]
                                   if s["name"] in names))
