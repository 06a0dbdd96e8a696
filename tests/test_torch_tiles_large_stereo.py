"""The stereo and foveated stereo frames of gsm_renderer_tpu_torch at tile
sides over 64 pixels, and the two-eye blend without a cutoff there (on the
CPU: the plain PyTorch versions of the kernels), against the JAX package
in interpret mode.

On the scene and rig of tests/test_torch_tiles_stereo.py (250 gaussians,
96x64 an eye):

* the dual-eye packed projection at 96x96 and 128x128 against JAX's
  ``stereo_project_and_cull_packed`` and the foveated tables at those
  tiles against JAX's ``foveated_raster_tables``;
* ``depth_first_stereo_frame`` at 96x96 (one tile an eye) and the
  foveated frame (``make_rate_maps(min_rate=0.4, radius=0.3)``) at
  128x128 (one tile larger than each eye's physical target);
* the two-eye blend without a cutoff against ``blend_tiles_pallas(
  n_eyes=2, r2_cutoff=0.0, interpret=True)`` on the stereo chain's sorted
  table at 96x96, weighted and first-hit depth.

Tolerances: those of tests/test_torch_tiles_odd_stereo.py, whose checks
this file runs.  JAX's frames are computed once per module.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tiles_odd_stereo import (  # noqa: E402
    check_foveated_tables, check_frame, check_stereo_projection,
    check_two_eye_blend_without_cutoff)
from test_torch_tiles_stereo import jax_frame  # noqa: E402
from test_torch_tiles_stereo import scene  # noqa: E402,F401  (fixture)

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)

TILES = [(96, 96), (128, 128)]
TILE_IDS = ["96x96", "128x128"]
#: name -> (kind, tile_w, tile_h, depth mode)
FRAMES = {
    "stereo_96x96": ("stereo", 96, 96, "weighted"),
    "foveated_128x128": ("foveated", 128, 128, "weighted"),
}


@pytest.fixture(scope="module")
def jax_frames(scene):  # noqa: F811
    return {name: jax_frame(scene, *spec) for name, spec in FRAMES.items()}


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_stereo_projection_matches_pallas(scene, tile):  # noqa: F811
    check_stereo_projection(scene, tile)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_foveated_tables_match_jax(scene, tile):  # noqa: F811
    check_foveated_tables(scene, tile)


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(scene, jax_frames, name):  # noqa: F811
    check_frame(scene, jax_frames[name], FRAMES[name])


@pytest.mark.parametrize("depth_mode", ["weighted", "first_hit"])
def test_two_eye_blend_without_cutoff_matches_pallas(scene,  # noqa: F811
                                                     depth_mode):
    check_two_eye_blend_without_cutoff(scene, (96, 96), depth_mode)
