"""The Local and Global frames of gsm_renderer_tpu_torch (16-bit depth
keys) at tile sides over 64 pixels (on the CPU: the plain PyTorch versions
of the kernels) against the JAX package's interpret-mode frames, on the
light scene of tests/test_torch_tiles_large.py: ``local_frame`` at 128x128
(one tile larger than the frame: its per-tile clamp and first-hit depth)
and ``global_frame`` at 128x64 with and without the exact tile test.

Tolerances: those of tests/test_torch_tiles.py (every header field equal,
colour within 1e-2, weighted depth within 5e-2, first-hit depth flips
capped at 0.5% of the pixels).  JAX's frames are computed once per module.
"""

import os
import sys

import pytest
import torch

from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.pipelines.global_ import global_frame as jax_global
from gsm_renderer_tpu.pipelines.local import local_frame as jax_local

from gsm_renderer_tpu_torch.pipelines.global_ import global_frame
from gsm_renderer_tpu_torch.pipelines.local import local_frame

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tiles import N, H, W, make_scene  # noqa: E402
from test_torch_tiles_odd import check_frame, jax_frames_of  # noqa: E402

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

#: name -> (JAX frame, port frame, keyword arguments)
FRAMES = {
    "local_128x128": (jax_local, local_frame, dict(tile_w=128, tile_h=128)),
    "global_128x64": (jax_global, global_frame, dict(tile_w=128, tile_h=64)),
    "global_128x64_no_exact_test": (
        jax_global, global_frame,
        dict(tile_w=128, tile_h=64, exact_tile_test=False)),
}


@pytest.fixture(scope="module")
def scene():
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.06)), W, H)


@pytest.fixture(scope="module")
def jax_frames(scene):
    return jax_frames_of(scene, None, FRAMES)


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, jax_frames, name):
    _jfn, pfn, kw = FRAMES[name]
    check_frame(scene, jax_frames[name], name, pfn, kw)
