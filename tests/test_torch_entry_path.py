"""The one path of every public render entry
(``GaussianRenderer.render_frame``, pipelines/base.py) on the CPU, at a
tiny scene: each entry of each renderer refuses an empty input and an
oversize frame with ``RendererError`` and keeps no capacity feedback of
them, counts one frame, leaves its capacity feedback under its own frame
kind and applies ``ColorFormat.RGBA16_FLOAT`` to its colour and depth.
This file imports no JAX."""

import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsm_renderer_tpu_torch import profiling as P
from gsm_renderer_tpu_torch.io.scene import generate_visible_gaussians

torch.set_num_threads(1)

W, H, N = 32, 24, 200
FOV = dict(min_rate=0.4, radius=0.3)
#: (renderer, entry, the frame kind its capacity feedback is kept under)
ENTRIES = [
    *((cls, entry, prefix + suffix)
      for cls, prefix in ((T.DepthFirstRenderer, "df"),
                          (T.HardwareRenderer, "hw"))
      for entry, suffix in (("render", ""), ("render_stereo", "_stereo"),
                            ("render_stereo_foveated", "_stereo_fov"),
                            ("render_stereo_foveated_compress", "_stereo"))),
    (T.GlobalRenderer, "render", "global"),
    (T.LocalRenderer, "render", "local"),
]


def call(r, entry, gi, width):
    """``entry`` of ``r`` on ``gi`` at a ``width`` x H display."""
    cam = T.make_camera(width, H, far=20.0)
    if entry == "render":
        return r.render(gi, cam, width, H)
    stereo = T.make_side_by_side_stereo(cam)
    if entry == "render_stereo":
        return r.render_stereo(gi, stereo, width, H)
    return getattr(r, entry)(gi, stereo, T.make_rate_maps(width, H, **FOV))


@pytest.mark.parametrize("cls,entry,kind", ENTRIES,
                         ids=[f"{c.__name__}.{e}" for c, e, _ in ENTRIES])
def test_entry_path(cls, entry, kind):
    gi = generate_visible_gaussians(N, sh_degree=1, seed=5,
                                    scale_range=(0.01, 0.06)).to_input(
                                        device="cpu")
    r = cls(T.RendererConfig(sh_degree=1, max_width=W, max_height=H,
                             color_format=T.ColorFormat.RGBA16_FLOAT),
            device="cpu")
    empty = T.GaussianInput(gi.positions[:0], gi.scales[:0],
                            gi.rotations[:0], gi.opacities[:0],
                            gi.harmonics[..., :0])
    with pytest.raises(T.RendererError, match="empty"):
        call(r, entry, empty, W)
    with pytest.raises(T.RendererError, match="exceeds"):
        call(r, entry, gi, 2 * W)
    assert r._cap_feedback == {}
    frames = P.counters()["frames"]
    out = call(r, entry, gi, W)
    assert P.counters()["frames"] == frames + 1
    assert set(r._cap_feedback) == {(kind, N)}
    assert out.color.dtype == out.depth.dtype == torch.float16
    assert torch.isfinite(out.color).all() and out.color.abs().sum() > 0
