"""gsm_renderer_tpu_torch.profiling on the CPU: the stage split's keys (the
JAX function's) and sums, and the chain it times, which must render the
image of ``DepthFirstRenderer(row_expand=False)`` bit for bit (the same
calls in the same order).  Times on the CPU are host-clock times of the
plain versions, not device metrics; chip_smoke.py reads the split on the
card."""

import numpy as np
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


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_profiled_chain_is_the_rows_off_frame(sh_degree):
    gi, cam = scene(sh_degree)
    st = {}
    for _name, fn in P._stage_chain(gi, cam, W, H, sh_degree=sh_degree,
                                    capacity=0, alpha_threshold=0.005,
                                    total_ink_threshold=2.0):
        fn(st)
    r = T.DepthFirstRenderer(T.RendererConfig(sh_degree=sh_degree,
                                              row_expand=False), device="cpu")
    ref = r.render(gi, cam, W, H)
    assert int(ref.header.overflow) == 0
    np.testing.assert_array_equal(st["color"].numpy(), ref.color.numpy())
    np.testing.assert_array_equal(st["depth"].numpy(), ref.depth.numpy())
    assert float(ref.color[..., :3].max()) > 0.05
