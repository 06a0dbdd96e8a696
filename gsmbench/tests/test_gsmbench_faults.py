"""A run with its timed path broken underneath comes out not correct.

Each test drives ``run.run_cell`` on the CPU (the look for a card is
``run.main``'s and is skipped) at a small size of each cell, with one fault
planted in the renderer's entry point that the frame calls; the sound run
comes out correct.  The faults a frame of these cells can have: a frame
that returns the state of the one before (a stale frame), half of the
scene left out, the image altered where it is produced, and frames that
overflowed (dropped splats) and came out wrong, which the run always
compares.  Neither cell
has an exchange between chips."""

import pytest
import torch

import gsm_renderer_tpu_torch as T
from gsmbench import run
from gsmbench.tests.conftest import TINY, tiny

ENTRY = {"garden-mono-1080p.orbit": "render",
         "xr-stereo-1m.foveated": "render_stereo_foveated"}
SEED = 2 ** 31 + 99


def _stale(method):
    last = {}

    def broken(self, gi, *args):
        if "out" not in last:
            last["out"] = method(self, gi, *args)
        return last["out"]
    return broken


def _half(method):
    def broken(self, gi, *args):
        n = gi.count // 2
        half = T.GaussianInput(gi.positions[:n], gi.scales[:n],
                               gi.rotations[:n], gi.opacities[:n],
                               gi.harmonics[:, :, :n])
        return method(self, half, *args)
    return broken


def _altered(method):
    def broken(self, gi, *args):
        out = method(self, gi, *args)
        h, w = out.color.shape[:2]
        y, x = (h // 32) * 16, (w // 32) * 16
        out.color[y:y + 16, x:x + 16, :3] = 1.0 - out.color[y:y + 16, x:x + 16, :3]
        return out
    return broken


def _overflowed(method):
    """Every third frame drops splats, says so in its header, and comes
    out altered: frames that the run's plain sample may miss."""
    calls = [0]

    def broken(self, gi, *args):
        calls[0] += 1
        out = _altered(method)(self, gi, *args) if calls[0] % 3 == 0 \
            else method(self, gi, *args)
        if calls[0] % 3 == 0:
            out.header.overflow = torch.ones((), dtype=torch.int32)
        return out
    return broken


@pytest.mark.parametrize("name,n,w,h", TINY)
def test_sound_run_is_correct(name, n, w, h):
    res = run.run_cell(tiny(name, n, w, h), SEED, 0.5, False, "cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _overflowed])
@pytest.mark.parametrize("name,n,w,h", TINY)
def test_fault_is_not_correct(monkeypatch, name, n, w, h, fault):
    method = getattr(T.DepthFirstRenderer, ENTRY[name])
    monkeypatch.setattr(T.DepthFirstRenderer, ENTRY[name], fault(method))
    torch.manual_seed(0)
    res = run.run_cell(tiny(name, n, w, h), SEED, 0.5, False, "cpu")
    assert res["attempted"] > 0
    assert not res["correct"], res["checks"]
    if fault is _overflowed:
        assert res["failed"] >= 1, res
