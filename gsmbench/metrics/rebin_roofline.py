"""rebin_roofline: the foveated re-bin's bound over its device time
(``rebin_ms``), in %, at harness/roofline.py's peaks.

The work any re-bin must do, from the reference's counts: each gaussian's
four float32 union pixel bounds and its visibility byte read (17 B, counted
as ``READ_BYTES``), a visible gaussian's physical rect word and rect_h
written (``WRITTEN_BYTES``), and ``FLOPS`` float32 operations a gaussian
(each bound: the normalization, a degree-9 Horner, the margin and the tile
multiply).  None where ``rebin_ms`` is None or the reference gave no
counts; 0.0 where the window launched no re-bin kernel."""

from gsmbench.harness import roofline

#: bytes read a gaussian: four float32 bounds and a visibility byte, 17 B,
#: rounded up
READ_BYTES = 20
#: bytes written a visible gaussian: the rect word and rect_h
WRITTEN_BYTES = 8
#: float32 operations a gaussian: 20 for each of its four bounds
FLOPS = 4 * 20


def bound(counts: dict):
    """(seconds, "bytes" or "operations") of the re-bin of one frame."""
    return roofline.bound_s(counts["gaussians"] * READ_BYTES
                            + counts["visible"] * WRITTEN_BYTES,
                            counts["gaussians"] * FLOPS)


def read(ctx):
    from gsmbench.metrics.rebin_ms import read as rebin_ms

    ms = rebin_ms(ctx)
    if ms is None or ctx.get("counts") is None:
        return None
    if ms == 0.0:
        return 0.0
    return 100.0 * bound(ctx["counts"])[0] * 1e3 / ms
