"""gsm_renderer_tpu_torch.profiling on the CPU: the stage split's keys (the
JAX function's) and sums.  The split reads the spans of the frame function
itself (tests/test_torch_tracing.py holds the spans to the frame).  Times
on the CPU are host-clock times of the plain versions, not device metrics;
chip_smoke.py reads the split on the card."""

import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

torch.set_num_threads(1)

W, H, N = 128, 96, 600


def scene(sh_degree):
    ds = generate_visible_gaussians(N, sh_degree=sh_degree, seed=5,
                                    scale_range=(0.01, 0.06))
    return ds.to_input(device="cpu"), T.make_camera(W, H, far=20.0)


def test_split_keys_and_total():
    gi, cam = scene(3)
    out = P.profile_depth_first_stages(gi, cam, W, H, sh_degree=3)
    assert list(out) == ["project", "prep", "expand", "sort", "ranges",
                         "blend", "total"]
    assert all(isinstance(v, float) and v > 0.0 for v in out.values())
    assert out["total"] == pytest.approx(sum(out[k] for k in P.STAGES),
                                         rel=1e-12)
