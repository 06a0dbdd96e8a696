"""Prep parity on built inputs, mode "warped" (the foveated frame's, on the
1080p foveated bounds table) at ``lod_min`` 0 and 5: the port's plain
``binning_prep`` against the JAX package's ``binning_prep_pallas``
(interpret mode) at 1, 31, 255, 256, 257 and 4097 gaussians.  Inputs and
tolerance: tests/test_torch_built_prep.py."""

import pytest
import torch

from test_torch_built_prep import SIZES, check_prep

# the suite runs files in parallel workers: one intra-op thread per worker
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["warped_lod0", "warped_lod5"])
@pytest.mark.parametrize("n", SIZES)
def test_warped_prep_matches_pallas_on_built_inputs(n, mode):
    check_prep(n, mode)
