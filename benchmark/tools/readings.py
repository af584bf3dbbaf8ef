"""The readings that a cell's comparison limits are set from, in one process.

    python3 benchmark/tools/readings.py --workload W --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3 [--precision tf32]

For each of ``--seeds`` the program's numbers, from a run of the cell's
traffic (its timed path for ``--seconds``, then the comparison); for each
of ``--control-seeds`` the control's: the reference one precision below
the configuration's in the program's place (and, for training, the fault
of half of each batch left out). ``--precision`` puts the reference in
another precision in the program's place, such as ``tf32``, the witness
of a float32 configuration that allows TF32. One JSON line per reading.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402


def main(argv=None, device=None, root=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", default="", help="default: one below the configuration's")
    args = ap.parse_args(argv)
    root = Path(root) if root is not None else ROOT
    here = root / "benchmark"
    cell = bench_run.read_json(here / "workloads" / f"{args.workload}.json")
    config = bench_run.read_json(here / "configs" / f"{cell['config']}.json")
    bench_run.set_cache_dirs()
    import torch

    from benchmark.reference.precision import control_precision

    device = device or "cuda"
    traffic = bench_run.load_file_module(here / "traffic" / f"{cell['traffic']}.py",
                                        f"bench_traffic_{cell['traffic']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    precision = args.precision or control_precision(config["experiment"]["model"])
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in controls]:
        ctx = bench_run.Context(args.workload, cell, config, seed, args.seconds, False, device)
        if kind == "program":
            out = traffic.run(ctx)
            line = {"kind": kind, "seed": seed, "checks": out["checks"], "e2e": out["e2e"],
                    "setup_s": ctx.setup_s, "notes": out.get("notes")}
        else:
            line = {"kind": kind, "precision": precision, "seed": seed,
                    "checks": traffic.control(ctx, precision)}
        print(json.dumps(line), flush=True)
        if device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
