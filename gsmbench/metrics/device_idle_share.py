"""device_idle_share: 100 * (1 - device busy / wall) over the traced
frames.  The profiler slows the host, so this is an upper bound of the
untraced frames' idle share."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
