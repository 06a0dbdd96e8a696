"""capacity_host_ms: host ms a traced frame in the renderer's
``gsm::capacity`` spans: the capacity contract's picks (their lock-in and
refresh reads, and the growth read from the pinned copy of the last
frame's demand) and the copies of the frame's own demand to the host.
None where the renderer opens no such span."""

from gsmbench.metrics._spans import mean, traced_frames


def read(ctx):
    frames = traced_frames(ctx)
    if frames and not any(s["name"] == "capacity" for f in frames
                          for s in f["spans"]):
        return None
    return mean(ctx, lambda f: sum(s["host_ms"] for s in f["spans"]
                                   if s["name"] == "capacity"))
