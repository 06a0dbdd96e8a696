"""launches_per_frame: device operations (kernels, copies, fills) the
profiler saw, a frame."""


def read(ctx):
    tr = ctx["trace"]
    return tr["launches"] / tr["frames"]
