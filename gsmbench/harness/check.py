"""The output check: frames the timed window rendered against the
reference's frames of the same poses.

Numbers compared, each the worst over a cell's sampled frames:

- ``color_mae``: mean |colour - reference| over every pixel and RGBA
  channel;
- ``color_off_share``: the share of those values off by more than
  ``OFF`` (1e-4: under a float16 step of values over 0.25, far over the
  float32 rounding of a blend);
- ``tile_mae_max``: the same mean over each 16x16 block of the image, the
  largest block's (a fault local to a few tiles);
- ``depth_rel_mae``: mean |depth - reference| over the reference's mean
  |depth|;
- ``visible_rel``: |header.visible_count - reference| over the reference's
  count.

Each difference is taken beyond the reference's exit slack (a pixel's
transmittance where its tile saturated: how far the 256-rank exit may move
it, reference/render.py), so that a tile test decided the other way by
float rounding, which moves where later tiles stop, is not read as a
fault.  A cell's workload file states the limit of each; the readings the
limits were set from are in PERF.md.
"""

from __future__ import annotations

import torch

NAMES = ("color_mae", "color_off_share", "tile_mae_max", "depth_rel_mae",
         "visible_rel")
BLOCK = 16
OFF = 1e-4


def compare(color, depth, visible: int, ref) -> dict:
    """The numbers of one frame against its reference frame ``ref``."""
    if tuple(color.shape) != tuple(ref.color.shape):
        return {k: float("inf") for k in NAMES}
    diff = torch.clamp((color.float() - ref.color).abs() - ref.slack[..., None],
                       min=0.0)
    h, w = diff.shape[:2]
    ph, pw = -(-h // BLOCK) * BLOCK, -(-w // BLOCK) * BLOCK
    padded = torch.zeros((ph, pw, 4), device=diff.device)
    padded[:h, :w] = diff
    ones = torch.zeros((ph, pw), device=diff.device)
    ones[:h, :w] = 1.0
    blocks = padded.reshape(ph // BLOCK, BLOCK, pw // BLOCK, BLOCK, 4).sum((1, 3, 4))
    area = ones.reshape(ph // BLOCK, BLOCK, pw // BLOCK, BLOCK).sum((1, 3)) * 4
    out = dict(color_mae=float(diff.mean()),
               color_off_share=float((diff > OFF).float().mean()),
               tile_mae_max=float((blocks / area.clamp(min=1)).max()))
    ddiff = torch.clamp((depth.float() - ref.depth).abs() - ref.slack_depth,
                        min=0.0).mean()
    out["depth_rel_mae"] = float(ddiff / ref.depth.abs().mean().clamp(min=1e-12))
    out["visible_rel"] = abs(int(visible) - ref.visible) / max(ref.visible, 1)
    for k, v in out.items():
        if v != v:  # NaN: not a frame
            out[k] = float("inf")
    return out


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in NAMES}


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NAMES)
