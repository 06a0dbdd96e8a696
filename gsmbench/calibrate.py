"""Readings that the output check's limits are set from, in one process.

    python3 gsmbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--program-control]

For each ``--seeds`` seed: one run of the cell (``run.run_cell``, a window
of ``--seconds``), its compared numbers (the lower readings).  For each
``--control-seeds`` seed: the control, the reference computed in bfloat16
in the renderer's place at the cell's size, against the float32
reference on the same seeded sample of the cell's poses.  With
``--program-control``, the renderer's own lower-precision output path
(``color_format`` RGBA16_FLOAT) on the control seeds.  One JSON line a
reading.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(cell, seed: int, device: str) -> dict:
    import numpy as np
    import torch

    from gsmbench.harness import check, scene as scene_mod, traffic
    from gsmbench.reference.render import Reference

    cfg = cell.config
    entry = cell.entry()
    scene = scene_mod.make_scene(cfg["scene"], seed, device)
    loop = traffic.poses(cell.traffic, cfg["viewpoint"], seed)
    rng = np.random.default_rng([int(seed), 11])
    picks = rng.choice(len(loop), size=cell.workload["sample_frames"],
                       replace=False)
    kw = dict(sh_degree=cfg["scene"]["sh_degree"], tile=cfg["tile"],
              alpha_threshold=cfg["renderer_config"].get("alpha_threshold", 0.005))
    exact = Reference(scene, **kw)
    low = Reference(scene, dtype=torch.bfloat16, **kw)
    readings = []
    for i in picks:
        want = entry.reference(exact, cfg, loop[int(i)])
        got = entry.reference(low, cfg, loop[int(i)])
        readings.append(check.compare(got.color, got.depth, got.visible, want))
        del want, got
    return check.worst(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from gsmbench import run
    from gsmbench.harness import cell as cell_mod

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = cell_mod.load(args.workload)
    for seed in args.seeds:
        res = run.run_cell(cell, seed, args.seconds, False, "cuda")
        print(json.dumps(dict(kind="program", seed=seed, correct=res["correct"],
                              failed=res["failed"], attempted=res["attempted"],
                              frame_ms=res["metrics"]["frame_ms"]["value"],
                              numbers={k: v["value"] for k, v in res["checks"].items()})),
              flush=True)
    for seed in args.control_seeds:
        print(json.dumps(dict(kind="control_bf16_reference", seed=seed,
                              numbers=control(cell, seed, "cuda"))), flush=True)
        if args.program_control:
            lowp = copy.deepcopy(cell)
            lowp.config["renderer_config"]["color_format"] = "rgba16Float"
            res = run.run_cell(lowp, seed, args.seconds, False, "cuda")
            print(json.dumps(dict(kind="control_program_rgba16", seed=seed,
                                  numbers={k: v["value"] for k, v in res["checks"].items()})),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
