"""The foveated re-bin's readers (``rebin_ms``, ``rebin_roofline``,
``span_rebin_ms``) on hand-made contexts, and the foveated garden cell run
on the CPU at a small size."""

import copy

import pytest

from gsmbench import run
from gsmbench.harness import cell as cell_mod
from gsmbench.tests.conftest import tiny

CELL = "garden-foveated-1080p.head-sway"
KERNEL = "void (anonymous namespace)::foveated_rebin_kernel(float const*)"


def reader(metric):
    return cell_mod.load(CELL).reader(metric)


def ctx_of(kernels, counts=None, frames=4):
    return dict(trace=dict(frames=frames, kernels=kernels, layers={}),
                counts=counts)


def test_rebin_ms_reads_the_rebin_kernels():
    """Device ms a frame of the kernels whose name holds ``rebin``, and no
    other; 0.0 where the window launched none."""
    kernels = {KERNEL: (0.0004, 4), "void prep_kernel<2>(int)": (0.002, 4),
               "void other_rebin_kernel(int)": (0.0002, 4)}
    assert reader("rebin_ms")(ctx_of(kernels)) == pytest.approx(0.15)
    assert reader("rebin_ms")(ctx_of({"void prep_kernel<2>(int)":
                                      (0.002, 4)})) == 0.0


def test_rebin_roofline_arithmetic():
    """bound / rebin_ms: 20 B read a gaussian and 8 B written a visible
    one at 3.35 TB/s (80 float32 operations a gaussian at 67 TFLOP/s stay
    below it), in %."""
    counts = dict(gaussians=5_800_000, visible=3_000_000)
    ctx = ctx_of({KERNEL: (0.0002, 4)}, counts)
    bound_s = (5_800_000 * 20 + 3_000_000 * 8) / 3.35e12
    assert 5_800_000 * 80 / 67e12 < bound_s
    assert reader("rebin_roofline")(ctx) == pytest.approx(
        100.0 * bound_s * 1e3 / 0.05)
    assert reader("rebin_roofline")(ctx_of({}, counts)) == 0.0
    assert reader("rebin_roofline")(ctx_of({KERNEL: (0.0002, 4)})) is None


def test_rebin_readers_of_a_renderer_without_the_kernel(monkeypatch):
    """A renderer that counts no ``rebin_kernel`` (one that re-bins in
    torch) gives the kernel readers nothing to read."""
    from gsm_renderer_tpu_torch import profiling

    counters = profiling.counters
    monkeypatch.setattr(profiling, "counters", lambda: {
        k: v for k, v in counters().items() if not k.startswith("rebin")})
    ctx = ctx_of({KERNEL: (0.0002, 4)}, dict(gaussians=10, visible=5))
    assert reader("rebin_ms")(ctx) is None
    assert reader("rebin_roofline")(ctx) is None


def test_span_rebin_ms(monkeypatch):
    """Device ms a traced frame of the ``gsm::rebin`` span."""
    from gsm_renderer_tpu_torch import profiling

    recs = [dict(spans=[dict(name="project", device_ms=0.7),
                        dict(name="rebin", device_ms=0.06)]),
            dict(spans=[dict(name="rebin", device_ms=0.08)])]
    monkeypatch.setattr(profiling, "frames", lambda: recs)
    assert reader("span_rebin_ms")(dict(trace=dict(frames=2))) \
        == pytest.approx(0.07)
    monkeypatch.delattr(profiling, "frames")
    assert reader("span_rebin_ms")(dict(trace=dict(frames=2))) is None


def test_tiny_foveated_garden_run_is_correct():
    """The cell's run on the renderer's CPU path at 3000 gaussians and
    160x96 an eye (splats enlarged to cover pixels there): correct, no
    frame failed."""
    cell = tiny(CELL, 3000, 160, 96)
    cell.config = copy.deepcopy(cell.config)
    cell.config["scene"]["scale_factor"] = 6.0
    res = run.run_cell(cell, 2 ** 31 + 99, 0.5, False, "cpu")
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
