"""The DepthFirst frame functions of gsm_renderer_tpu_torch at tile sides
over 64 pixels (on the CPU: the plain PyTorch versions of the kernels)
against the JAX package's interpret-mode frames, on the scenes of
tests/test_torch_tiles_large.py (whose stages it leaves to that file):
``depth_first_frame`` at 128x96 (one tile holds the frame), with rows at
96x80 on the tall scene, and the Hardware frame at 80x72.
tests/test_torch_tiles_large_d16.py holds the Local and Global frames.

Tolerances: those of tests/test_torch_tiles.py (every header field equal,
colour within 1e-2, depth within 5e-2, normalized depth where alpha >
0.05, first-hit depth flips capped at 0.5% of the pixels).  JAX's frames
are computed once per module.
"""

import os
import sys

import pytest
import torch

from gsm_renderer_tpu.io.scene import generate_visible_gaussians as jax_gen
from gsm_renderer_tpu.pipelines.depth_first import depth_first_frame as jax_df

from gsm_renderer_tpu_torch.pipelines.depth_first import depth_first_frame

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tiles import HEAVY_CAP, N, ROWS, H, W, make_scene  # noqa: E402
from test_torch_tiles_large import tall_scene  # noqa: E402
from test_torch_tiles_odd import check_frame, jax_frames_of  # noqa: E402

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

#: name -> (JAX frame, port frame, keyword arguments); "rows" frames on the
#: tall scene
FRAMES = {
    "df_128x96": (jax_df, depth_first_frame, dict(tile_w=128, tile_h=96)),
    "rows_96x80": (jax_df, depth_first_frame,
                   dict(tile_w=96, tile_h=80, row_capacity=ROWS,
                        capacity=HEAVY_CAP)),
    "hardware_80x72": (jax_df, depth_first_frame,
                       dict(tile_w=80, tile_h=72, exact_tile_test=False,
                            depth_mode="normalized", r2_cutoff=9.0)),
}


@pytest.fixture(scope="module")
def scene():
    return make_scene(jax_gen(N, sh_degree=1, scale_range=(0.01, 0.06)), W, H)


@pytest.fixture(scope="module")
def tall():
    return tall_scene()


@pytest.fixture(scope="module")
def jax_frames(scene, tall):
    return jax_frames_of(scene, tall, FRAMES)


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, tall, jax_frames, name):
    _jfn, pfn, kw = FRAMES[name]
    check_frame(tall if name.startswith("rows") else scene, jax_frames[name],
                name, pfn, kw)
