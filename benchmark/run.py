"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell's file ``benchmark/workloads/<name>.json``
names its configuration (``benchmark/configs/<config>.json``), its traffic
kind (the module ``benchmark/traffic/<traffic>.py``) and the traffic's
parameters and comparison limits; ``BENCHMARK.json`` names the cell's
metrics, and each per-layer metric has its reader in
``benchmark/metrics/<name>.py``. The traffic module builds the program's state and
inputs from the seed, warms every shape it uses (all of that is
``setup_s``), measures for ``--seconds``, then compares what the timed path
produced with the plain reference (``benchmark/reference``).

The last lines on standard error give each compared number beside its
limit; the last line on standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "shape_based_object_detection_tpu")
MISSING = 1e9  # the reading of a compared number that a run did not produce
# a traced run measures at most this long: the profiler's events of a longer
# window take minutes to read
TRACE_WINDOW_S = 10.0


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this
    module was loaded where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - START


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Context:
    """What a traffic module gets: the cell, its configuration, the run's
    arguments and the device; ``sub_seed`` derives independent seeds."""

    def __init__(self, name, cell, config, seed, seconds, trace, device):
        self.name, self.cell, self.config = name, cell, config
        self.params = cell["params"]
        self.limits = cell["limits"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.setup_s = None
        self.marks = []  # (phase, process age in s as it ended): set-up's breakdown

    def mark(self, phase: str) -> None:
        """Note that set-up's ``phase`` has ended (after the device's work)."""
        if str(self.device).startswith("cuda"):
            import torch

            torch.cuda.synchronize()
        self.marks.append((phase, round(process_age_s(), 3)))

    def sub_seed(self, tag: str) -> int:
        import zlib

        import numpy as np

        state = np.random.SeedSequence([self.seed, zlib.crc32(tag.encode())])
        return int(state.generate_state(1, np.uint64)[0]) >> 1

    def window_opens(self) -> None:
        """Called by the traffic module as its first timed unit of work starts."""
        self.setup_s = process_age_s()
        self.marks.append(("window", round(self.setup_s, 3)))


def cell_metrics(bench: dict, name: str, section: str):
    """The metrics of ``section`` that the cell reports."""
    out = []
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    for m in bench[section]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def main(argv=None, device=None, root=None) -> int:
    """One run. ``device`` skips the look for a card and runs there (the
    CPU tests); ``root`` reads BENCHMARK.json and the cell's files from
    another checkout."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path(root) if root is not None else ROOT
    here = root / "benchmark"
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = read_json(here / "workloads" / f"{args.workload}.json")
    config = read_json(here / "configs" / f"{cell['config']}.json")

    set_cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    marks = [("python", round(process_age_s(), 3))]
    import torch

    marks.append(("torch", round(process_age_s(), 3)))

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"the cell needs {entry['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        torch.empty(0, device=device)  # the context
        marks.append(("cuda", round(process_age_s(), 3)))

    seconds = min(args.seconds, TRACE_WINDOW_S) if args.trace else args.seconds
    ctx = Context(args.workload, cell, config, args.seed, seconds, bool(args.trace), device)
    ctx.marks.extend(marks)
    traffic = load_file_module(here / "traffic" / f"{cell['traffic']}.py",
                              f"bench_traffic_{cell['traffic']}")
    out = traffic.run(ctx)

    metrics = {}
    if args.trace:
        records = dict(out["records"], timeline=out["timeline"])
        for m in cell_metrics(bench, args.workload, "per_layer"):
            reader = load_file_module(here / "metrics" / f"{m['name']}.py",
                                      "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            value = ctx.setup_s if m["name"] == "setup_s" else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": entry["chips"],
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace:
        tl = out["timeline"]
        device_info.update(busy_s=tl["busy_s"], window_s=tl["window_s"])
        result["breakdown"] = {"device_ops": tl["device_ops"], "idle_gaps": tl["idle_gaps"]}

    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    print(f"note setup_phases {ctx.marks!r}", file=sys.stderr)
    for k, v in out.get("notes", {}).items():
        print(f"note {k} {v!r}", file=sys.stderr)
    for k, v in out["checks"].items():
        if k not in ctx.limits:  # read, but no limit holds it (PERF.md)
            print(f"note {k} {v!r} not compared", file=sys.stderr)
    checks = {k: {"value": out["checks"].get(k, MISSING), "limit": limit}
              for k, limit in ctx.limits.items()}
    checks["failed"] = {"value": out["failed"], "limit": 0}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # compiled bytecode, torch's included, kept at a fixed place in the
    # checkout: where the installed packages carry none, or the environment
    # forbids writing it, every run would compile them all again
    sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
