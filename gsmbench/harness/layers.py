"""Shared arithmetic of the per-layer readers: a layer's device time a
frame and its roofline share."""

def ms(ctx, layer: str):
    """Device ms a frame of ``layer`` over the traced frames; None where the
    trace saw none of its kernels."""
    tr = ctx["trace"]
    sec = tr["layers"].get(layer)
    return None if not sec else sec * 1e3 / tr["frames"]


def share(ctx, layer: str, bound):
    """bound / measured time, in %; None where either is missing."""
    t = ms(ctx, layer)
    if t is None or ctx.get("counts") is None:
        return None
    return 100.0 * bound(ctx)[0] * 1e3 / t
