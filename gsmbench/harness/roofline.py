"""The least time a stage could take on the card, from the work any
implementation of the stage must do.

Bound = max(bytes / peak bandwidth, float32 operations / peak float32
rate), against the NVIDIA H100 SXM data sheet (dense, at the full 700 W
power limit; a run reports the card's own limit beside it).  The counts
come from the inputs' shapes and from the reference's counts on one frame
(:class:`gsmbench.reference.render.Frame` ``counts``), never from the
renderer's own outputs, so the bound is the same whatever implements the
stage.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: one render record as the blend needs it: the upstream's 16-byte record
#: (mean 2 x f16, orientation u16 + sigma1 f16, sigma2 f16 + depth f16,
#: RGBA8); a stereo record carries each eye's 12 bytes of geometry and the
#: shared 4 bytes of colour
RECORD_BYTES = {1: 16, 2: 28}
#: one sort key (8 bytes: tile, depth, index) and one entry word (4 bytes)
#: written for each binned (gaussian, tile) pair
PAIR_BYTES = 12
#: one output pixel an eye: RGBA float32 and depth float32
PIXEL_BYTES = 20
#: float32 operations a gaussian of the projection (SH3: EWA covariance,
#: stabilization, eigen-decomposition, SH colour, culls and packing), one
#: camera and two, as counted from the operations the chain needs
PROJECT_FLOPS = {1: 520, 2: 860}
#: float32 operations of one exact tile test (decode a record's conic,
#: the minimum of its quadratic form over the tile) an eye
TILE_TEST_FLOPS = 65
#: float32 operations of one pixel composite (offset, quadratic form, exp,
#: clamp, weight, colour, depth, transmittance)
BLEND_PAIR_FLOPS = 25


def input_bytes(sh_degree: int, precision: str) -> int:
    """Bytes of one gaussian in the user-facing input layout: float32
    position, then scale, rotation, opacity and SH in ``precision``."""
    k = (sh_degree + 1) ** 2
    each = 2 if precision == "float16" else 4
    return 12 + each * (3 + 4 + 1 + 3 * k)


def bound_s(nbytes: float, flops: float):
    """(seconds, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def project(counts: dict, sh_degree: int, precision: str):
    eyes = counts["eyes"]
    return bound_s(counts["gaussians"] * input_bytes(sh_degree, precision)
                   + counts["visible"] * RECORD_BYTES[eyes],
                   counts["gaussians"] * PROJECT_FLOPS[eyes])


def binning(counts: dict):
    eyes = counts["eyes"]
    return bound_s(counts["visible"] * RECORD_BYTES[eyes]
                   + counts["pairs"] * PAIR_BYTES,
                   counts["pairs"] * TILE_TEST_FLOPS * eyes)


def blend(counts: dict):
    return bound_s(counts["blend_records"] * RECORD_BYTES[counts["eyes"]]
                   + counts["pixels"] * PIXEL_BYTES,
                   counts["blend_pairs"] * BLEND_PAIR_FLOPS)
