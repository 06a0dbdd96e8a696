"""A cell and what it is made of, found by name.

``BENCHMARK.json`` at the repository root lists the cells (``workloads``),
configurations and metrics.  Everything that belongs to one of them sits in
files of its own, found by its name:

- ``gsmbench/workloads/<cell>.json``: the configuration and traffic mix the
  cell joins, its run sizes (warm-up, sampled and traced frames) and the
  limits of its output check;
- ``gsmbench/configs/<config>.json``: the scene, the renderer and the
  entry point it drives, the camera;
- ``gsmbench/traffic/<traffic>.json``: the pose loop's parameters;
- ``gsmbench/entries/<entry>.py``: how a frame of that entry point is
  rendered by the renderer and by the reference;
- ``gsmbench/metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    manifest: dict

    @property
    def chips(self) -> int:
        return next(w["chips"] for w in self.manifest["workloads"]
                    if w["name"] == self.name)

    @property
    def end_to_end(self) -> list:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    @property
    def per_layer(self) -> list:
        return [m for m in self.manifest["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def entry(self):
        name = self.config["entry"]
        return load_module(BENCH_DIR / "entries" / f"{name}.py",
                           f"gsmbench_entry_{name}")

    def reader(self, metric: str):
        return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                           f"gsmbench_metric_{metric}").read


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else manifest()
    listed = {w["name"]: w for w in bench["workloads"]}
    if name not in listed:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _json(BENCH_DIR / "workloads" / f"{name}.json")
    config = _json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    traffic = _json(BENCH_DIR / "traffic" / f"{workload['traffic']}.json")
    return Cell(name, workload, config, traffic, bench)
