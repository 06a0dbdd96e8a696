"""dead_slot_share: 100 x the mean over the traced frames of
max(capacity - slot total, 0) / capacity: the share of the sorted slots
that held no instance (the capacity contract's margin, which the sort and
its glue work through)."""

from gsmbench.metrics._spans import mean


def _dead(frame) -> float:
    cap, total = frame["capacity"], frame["slot_total"]
    if not cap or total is None:
        return 0.0
    return 100.0 * max(cap - total, 0) / cap


def read(ctx):
    return mean(ctx, _dead)
