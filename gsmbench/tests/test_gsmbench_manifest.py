"""BENCHMARK.json against its contract's form, every cell resolving to its
files by name, and the roofline counts on a tiny scene."""

import json
import re

import pytest
import torch

from gsmbench.harness import cell as cell_mod, roofline, scene as scene_mod
from gsmbench.harness import traffic
from gsmbench.reference.render import Reference
from gsmbench.tests.conftest import tiny

BENCH = cell_mod.BENCH_DIR
MANIFEST = cell_mod.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) \
        == len(MANIFEST["workloads"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = cell_mod.load(name)
    listed = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    assert (cell.workload["config"], cell.workload["traffic"]) == (
        listed["config"], listed["traffic"])
    config = next(c for c in MANIFEST["configs"] if c["name"] == listed["config"])
    assert (BENCH.parent / config["file"]).is_file()
    assert cell.config["name"] == config["name"]
    assert cell.config["reduced"] == config["reduced"]
    assert callable(cell.entry().build) and callable(cell.entry().reference)
    assert set(cell.workload["limits"]) == {"color_mae", "color_off_share",
                                            "tile_mae_max", "depth_rel_mae",
                                            "visible_rel"}
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_per_layer_reader(metric):
    m = next(x for x in MANIFEST["per_layer"] if x["name"] == metric)
    assert (BENCH / "metrics" / f"{metric}.py").is_file()
    assert LINE.match(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    e2e = next(x for x in MANIFEST["end_to_end"] if x["name"] == m["moves"])
    for name in m.get("workloads", CELLS):
        assert name in e2e.get("workloads", CELLS)
    cell = cell_mod.load(CELLS[0])
    assert callable(cell.reader(metric))


def test_readers_on_a_made_up_trace():
    """Every reader turns a trace, a split and reference counts into a
    number, and a layer the trace did not see into nothing."""
    cell = cell_mod.load(CELLS[0])
    tr = dict(frames=4, window_s=0.04, busy_s=0.03, launches=280,
              layers=dict(project=0.002, binning=0.002, sort=0.004,
                          glue=0.004, blend=0.003), kernels={})
    counts = dict(gaussians=1000, visible=800, pairs=3000, pairs_tested=4000,
                  pixels=10000, eyes=1, blend_pairs=50000, blend_records=2000)
    ctx = dict(trace=tr, split=dict(host_ms=1.5, device_ms=2.0, host_ahead=True),
               counts=counts, config=cell.config)
    for m in MANIFEST["per_layer"]:
        value = cell.reader(m["name"])(ctx)
        assert isinstance(value, float) and value >= 0.0, m["name"]
    assert cell.reader("launches_per_frame")(ctx) == 70.0
    assert abs(cell.reader("device_idle_share")(ctx) - 25.0) < 1e-9
    tr["layers"].pop("blend")
    assert cell.reader("blend_ms")(ctx) is None
    assert cell.reader("blend_roofline")(ctx) is None


def test_roofline_counts_on_a_tiny_scene():
    assert roofline.input_bytes(3, "float16") == 124
    cell = tiny("garden-mono-1080p.orbit", 3000, 96, 64)
    cfg = cell.config
    scene = scene_mod.make_scene(cfg["scene"], 4, "cpu")
    pose = traffic.poses(cell.traffic, cfg["viewpoint"], 4)[0]
    frame = cell.entry().reference(Reference(scene, sh_degree=3), cfg, pose)
    c = frame.counts
    assert c["gaussians"] == 3000 and 0 < c["visible"] <= 3000
    assert c["visible"] <= c["pairs"] <= c["pairs_tested"]
    assert c["pixels"] == 96 * 64 and c["eyes"] == 1
    assert 0 < c["blend_records"] <= c["pairs"]
    assert 0 < c["blend_pairs"] <= c["pairs"] * 256
    t, by = roofline.project(c, 3, "float16")
    assert by == "bytes"
    assert t == pytest.approx((3000 * 124 + c["visible"] * 16) / 3.35e12)
    t, _ = roofline.binning(c)
    assert t >= (c["visible"] * 16 + c["pairs"] * 12) / 3.35e12
    t, _ = roofline.blend(c)
    assert t >= max(c["blend_pairs"] * 25 / 67e12,
                    (c["blend_records"] * 16 + 96 * 64 * 20) / 3.35e12) * (1 - 1e-12)
    # every alpha-passing composite before a pixel's exit is counted once:
    # at most the pairs times the tile's pixels, and an opaque scene far
    # fewer than the pairs of a tile with no exit
    assert torch.is_tensor(frame.color)


def test_trace_reduction_on_a_made_up_trace():
    """Layers by kernel name, the sort's helper kernels by the host op that
    launched them, busy time as the union of device intervals, and idle
    gaps named by the launching host op."""
    from gsmbench.harness.trace import breakdown, reduce_events

    def op(cat, name, ts, dur, corr=None):
        e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=1)
        if corr is not None:
            e["args"] = dict(correlation=corr)
        return e

    events = [op("cpu_op", "aten::sort", 0, 50), op("cpu_op", "aten::copy_", 10, 5),
              op("cuda_runtime", "cudaLaunchKernel", 12, 1, 7),
              op("cuda_runtime", "cudaLaunchKernel", 60, 1, 8),
              op("cuda_runtime", "cudaLaunchKernel", 70, 1, 9),
              op("kernel", "void direct_copy_kernel(int)", 100, 10, 7),
              op("kernel", "void project_kernel<3>(int)", 130, 10, 8),
              op("kernel", "void (anonymous namespace)::general_blend_kernel<1>(int)",
                 135, 20, 9),
              # the harness's own copy of the overflow flag is left out
              op("user_annotation", "gsmbench_check", 80, 5),
              op("cpu_op", "aten::copy_", 81, 3),
              op("cuda_runtime", "cudaMemcpyAsync", 82, 1, 10),
              op("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 160, 2, 10)]
    r = reduce_events(events)
    assert r["layers"] == pytest.approx(dict(sort=10e-6, project=10e-6, blend=20e-6))
    assert r["busy_s"] == pytest.approx(35e-6) and r["launches"] == 3
    assert r["gaps"] == pytest.approx({"host -> project_kernel<3>": 20e-6})
    b = breakdown(r)
    assert b["device_ops"][0] == ["general_blend_kernel<1>", pytest.approx(20e-6)]
