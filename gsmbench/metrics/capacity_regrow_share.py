"""capacity_regrow_share: 100 x the capacity contract's growths between
refreshes (counter ``capacity_regrows``, as each traced frame recorded it)
over the traced frames: how often the slot or row demand outgrew the
capacity's margin within a refresh window.  None where the renderer's
frame records keep no counters."""

from gsmbench.metrics._spans import mean, traced_frames


def read(ctx):
    frames = traced_frames(ctx)
    if frames and any("counters" not in f for f in frames):
        return None
    value = mean(ctx, lambda f: f["counters"].get("capacity_regrows", 0))
    return None if value is None else 100.0 * value
