"""graph_replay_share: 100 x the frames replayed from a CUDA graph (counter
``graph_replays``, as each traced frame recorded it) over the traced
frames: how much of the window the renderer rendered as one graph launch a
frame rather than eagerly.  None where the renderer counts no replays."""

from gsmbench.metrics._spans import mean, traced_frames


def read(ctx):
    from gsm_renderer_tpu_torch import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or "graph_replays" not in counters():
        return None
    frames = traced_frames(ctx)
    if frames and any("counters" not in f for f in frames):
        return None
    value = mean(ctx, lambda f: f["counters"].get("graph_replays", 0))
    return None if value is None else 100.0 * value
