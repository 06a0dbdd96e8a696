"""Fixtures of the benchmark's own tests (CPU unless marked ``card``)."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


#: a cell that BENCHMARK.json does not list yet: the foveated XR head, left
#: out while the renderer's adaptive capacity drops splats under its head
#: sway (PERF.md, Open questions); its entry, reference and traffic stay
#: held here, with the limits its still-head readings gave
PENDING = {"xr-stereo-1m.foveated": dict(
    config="xr-stereo-1m", traffic="head-sway", warmup_frames=8,
    sample_frames=4, trace_frames=30,
    limits=dict(color_mae=1.5e-05, color_off_share=0.01, tile_mae_max=0.04,
                depth_rel_mae=1.5e-05, visible_rel=0.0001))}


def load(name: str):
    """Cell ``name`` of BENCHMARK.json, or of ``PENDING``."""
    from gsmbench.harness import cell as cell_mod

    if name not in PENDING:
        return cell_mod.load(name)
    wl = PENDING[name]
    bench = copy.deepcopy(cell_mod.manifest())
    bench["workloads"].append(dict(name=name, config=wl["config"],
                                   traffic=wl["traffic"], chips=1))
    read = lambda *p: json.loads(cell_mod.BENCH_DIR.joinpath(*p).read_text())
    return cell_mod.Cell(name, dict(wl), read("configs", wl["config"] + ".json"),
                         read("traffic", wl["traffic"] + ".json"), bench)


def tiny(name: str, count: int, width: int, height: int, **workload):
    """Cell ``name`` (of BENCHMARK.json or ``PENDING``) at a size a CPU
    test holds: its configuration with ``count`` gaussians at ``width`` x
    ``height``."""
    cell = load(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["scene"]["count"] = count
    cell.config["width"], cell.config["height"] = width, height
    cell.config["renderer_config"].update(max_width=width, max_height=height)
    cell.workload = dict(cell.workload, warmup_frames=2, sample_frames=2,
                         **workload)
    return cell


#: (cell, gaussians, width, height) of the CPU tests
TINY = (("garden-mono-1080p.orbit", 6000, 128, 96),
        ("xr-stereo-1m.foveated", 3000, 160, 96))
