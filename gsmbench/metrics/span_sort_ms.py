"""span_sort_ms: device ms a traced frame of the sort and the tile ranges
(``gsm::sort``: the int64 key packing and ``torch.sort``; ``gsm::ranges``:
sorted tile ids and ``searchsorted``), from the renderer's span markers on
the stream."""

from gsmbench.metrics._spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "sort", "ranges")
