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

A cell whose ``chips`` is 1 runs in this process. A cell whose ``chips`` is
N > 1 runs as N rank processes, one per card. This process, the launcher,
checks that N cards are there, creates no CUDA context, and starts N
copies of this script (the same interpreter, the same bytecode cache in
``.bench_cache/pycache``), each with torchrun's environment: ``RANK`` and
``LOCAL_RANK`` r, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` N, ``MASTER_ADDR``
127.0.0.1, a free ``MASTER_PORT`` on the loopback, and ``OMP_NUM_THREADS`` 1
where it is unset. Rank r takes card r (``torch.cuda.set_device``) before
its first CUDA call and hands the traffic module ``ctx.rank`` r and
``ctx.world`` N (0 and 1 on one card). The traffic module joins the group
through the program's own ``parallel.mesh.initialize_multihost``, as
``train_cli`` does under torchrun, and leaves it; the harness forms no
group. Of the ranks' results the launcher prints one line for the cell:

- ``e2e``, ``checks`` and ``attempted`` are rank 0's; the traffic module
  makes them the group's (images of the global batch per second, a peak
  taken as the MAX over the group);
- ``memory_peak_bytes`` in ``device`` is the largest of the ranks', and
  ``failed`` the sum over the ranks;
- ``correct`` is false unless every rank finished and rank 0's checks are
  within their limits;
- ``setup_s`` is the launcher's age (from /proc) when the last rank opened
  its window: each rank reports the wall-clock time at which it did;
- with ``--trace 1`` every rank runs the profiler, so the ranks stay in
  step; the per-layer readers and ``breakdown`` read rank 0's records, and
  ``device`` gains rank 0's ``busy_s`` and ``window_s``;
- every rank checks ``FORBIDDEN`` on its own modules, and a rank that
  loaded one makes the run exit 3.

A rank that exits nonzero, is killed, sends no result, or is still running
``--seconds`` + ``RANK_DEADLINE_S`` after the launch ends the run: the
launcher kills every rank it started, prints the last lines of each rank's
standard error under ``rank <r>``, and exits 1 with no result line. The
kernel kills a rank whose launcher has died (``PR_SET_PDEATHSIG``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
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
# a rank still running this long after --seconds from its launch ends the run
RANK_DEADLINE_S = 600.0
RESULT_TAG = "bench-rank-result "  # a rank's result, on its standard output
# the end of each rank's standard error that a failed run prints: four
# ranks' fit in the 8,000 characters of it that a run's record keeps
TAIL_LINES, TAIL_CHARS = 40, 1800


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

    def __init__(self, name, cell, config, seed, seconds, trace, device, rank=0, world=1):
        self.name, self.cell, self.config = name, cell, config
        self.params = cell["params"]
        self.limits = cell["limits"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.rank, self.world = rank, world
        self.setup_s = None
        self.window_wall = None  # time.time() as the window opened
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
        self.window_wall = time.time()
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
    # given by the launcher to a rank process: its own pid, and main's arguments
    ap.add_argument("--rank-of", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--device", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    is_rank = args.rank_of is not None
    if is_rank:
        die_with_launcher(args.rank_of)
        device, root = args.device, args.root

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

    if device is None and not is_rank:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"the cell needs {entry['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    if entry["chips"] > 1 and not is_rank:
        return launch(args, entry["chips"], device, root, cell["limits"])
    rank, world = 0, 1
    if is_rank:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        if is_rank:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        device = "cuda"
        torch.empty(0, device=device)  # the context
        marks.append(("cuda", round(process_age_s(), 3)))

    seconds = min(args.seconds, TRACE_WINDOW_S) if args.trace else args.seconds
    ctx = Context(args.workload, cell, config, args.seed, seconds, bool(args.trace), device,
                  rank, world)
    ctx.marks.extend(marks)
    traffic = load_file_module(here / "traffic" / f"{cell['traffic']}.py",
                              f"bench_traffic_{cell['traffic']}")
    report = measure(ctx, traffic, bench, here)
    if is_rank:
        print(RESULT_TAG + json.dumps(report, default=plain), flush=True)
        return 0
    return emit(report, ctx.limits, entry["chips"], args.trace)


def measure(ctx, traffic, bench: dict, here: Path) -> dict:
    """Run the traffic module and read the metrics of its run: what one
    process reports of a cell."""
    out = traffic.run(ctx)

    metrics = {}
    if ctx.trace:
        if ctx.rank == 0:
            records = dict(out["records"], timeline=out["timeline"])
            for m in cell_metrics(bench, ctx.name, "per_layer"):
                reader = load_file_module(here / "metrics" / f"{m['name']}.py",
                                          "bench_metric_" + m["name"].replace(".", "_"))
                value = reader.read(records)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, ctx.name, "end_to_end"):
            value = ctx.setup_s if m["name"] == "setup_s" else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    import torch

    dev = torch.device(ctx.device)
    report = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "memory_peak_bytes": out["memory_peak_bytes"],
        "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
        "checks": out["checks"], "notes": out.get("notes", {}), "marks": ctx.marks,
        "window_wall": ctx.window_wall,
    }
    if ctx.trace:
        report["timeline"] = {k: out["timeline"][k]
                              for k in ("busy_s", "window_s", "device_ops", "idle_gaps")}
    report["loaded"] = loaded_forbidden()
    return report


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def emit(report: dict, limits: dict, count: int, trace) -> int:
    """Print the notes, each compared number beside its limit, and the
    result line of a run whose process or ranks reported ``report``."""
    device_info = {
        "platform": report["platform"],
        "kind": report["kind"],
        "count": count,
        "memory_peak_bytes": report["memory_peak_bytes"],
    }
    result = {"correct": None, "attempted": report["attempted"], "failed": report["failed"],
              "metrics": report["metrics"], "device": device_info}
    if trace:
        tl = report["timeline"]
        device_info.update(busy_s=tl["busy_s"], window_s=tl["window_s"])
        result["breakdown"] = {"device_ops": tl["device_ops"], "idle_gaps": tl["idle_gaps"]}

    found = report["loaded"]
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    print(f"note setup_phases {report['marks']!r}", file=sys.stderr)
    for k, v in report["notes"].items():
        print(f"note {k} {v!r}", file=sys.stderr)
    for k, v in report["checks"].items():
        if k not in limits:  # read, but no limit holds it (PERF.md)
            print(f"note {k} {v!r} not compared", file=sys.stderr)
    checks = {k: {"value": report["checks"].get(k, MISSING), "limit": limit}
              for k, limit in limits.items()}
    checks["failed"] = {"value": report["failed"], "limit": 0}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def plain(obj):
    """A number or list for what json cannot write (numpy's scalars and arrays)."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


def die_with_launcher(launcher_pid: int) -> None:
    """Have the kernel kill this rank process when its launcher ends."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, int(signal.SIGKILL), 0, 0, 0) != 0:  # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != launcher_pid:  # it ended before the call above
        os._exit(1)


class Rank:
    """A rank process the launcher started, with its result (the line its
    standard output tagged) and the end of its standard error."""

    def __init__(self, r: int, cmd: list, env: dict):
        self.r = r
        self.proc = subprocess.Popen(cmd, env=env, stdin=subprocess.DEVNULL,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, errors="replace", start_new_session=True)
        self.result = None
        self.err = collections.deque(maxlen=TAIL_LINES)
        self.readers = [threading.Thread(target=self._read, args=(f,), daemon=True)
                        for f in (self.proc.stdout, self.proc.stderr)]
        for t in self.readers:
            t.start()

    def _read(self, stream) -> None:
        for line in stream:
            if stream is self.proc.stderr:
                self.err.append(line.rstrip("\n"))
            elif line.startswith(RESULT_TAG):
                self.result = line[len(RESULT_TAG):]

    def stop(self) -> None:
        """Kill what is left of the rank's process group and reap the rank."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:  # the rank ended and left nothing behind
            pass
        self.proc.wait()
        for t in self.readers:
            t.join(timeout=10)

    def tail(self) -> str:
        return "\n".join(self.err)[-TAIL_CHARS:]


def wait_ranks(ranks: list, deadline: float, seconds: float):
    """None once every rank has ended with its result, else what went wrong."""
    while True:
        running, failed = [], []
        for rk in ranks:
            rc = rk.proc.poll()
            if rc is None:
                running.append(rk.r)
            elif rc < 0:
                failed.append(f"rank {rk.r} was killed by signal {-rc}")
            elif rc > 0:
                failed.append(f"rank {rk.r} exited with code {rc}")
        if failed:  # all that have failed by now: the first may bring the others down
            return ", ".join(failed)
        if not running:
            break
        if time.monotonic() > deadline:
            return (f"rank(s) {running} still running {seconds + RANK_DEADLINE_S:.0f} s "
                    "after the launch")
        time.sleep(0.1)
    for rk in ranks:
        rk.readers[0].join(timeout=10)
        if rk.result is None:
            return f"rank {rk.r} sent no result"
    return None


def launch(args, n: int, device, root: Path, limits: dict) -> int:
    """Run the cell as ``n`` rank processes and print its result line."""
    started_wall = time.time() - process_age_s()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--rank-of", str(os.getpid()), "--root", str(root)]
    if device is not None:
        cmd += ["--device", str(device)]
    deadline = time.monotonic() + args.seconds + RANK_DEADLINE_S
    ranks = []
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            env.setdefault("OMP_NUM_THREADS", "1")
            ranks.append(Rank(r, cmd, env))
        fault = wait_ranks(ranks, deadline, args.seconds)
    finally:
        for rk in ranks:
            rk.stop()
    if fault is not None:
        for rk in ranks:
            print(f"rank {rk.r} (exit code {rk.proc.returncode}), the end of its "
                  f"standard error:\n{rk.tail()}", file=sys.stderr)
        print(f"the run failed: {fault}", file=sys.stderr)
        return 1

    reports = [json.loads(rk.result) for rk in ranks]
    for rk, rep in zip(ranks, reports):
        if rep["loaded"]:
            print(f"rank {rk.r} loaded {', '.join(rep['loaded'])}", file=sys.stderr)
    report = reports[0]
    report["failed"] = sum(rep["failed"] for rep in reports)
    report["memory_peak_bytes"] = max(rep["memory_peak_bytes"] for rep in reports)
    report["loaded"] = sorted(set(loaded_forbidden()).union(*(rep["loaded"] for rep in reports)))
    windows = [rep["window_wall"] - started_wall for rep in reports]
    report["notes"]["rank_windows_s"] = [round(w, 3) for w in windows]
    if "setup_s" in report["metrics"]:
        report["metrics"]["setup_s"]["value"] = max(windows)
    return emit(report, limits, n, args.trace)


if __name__ == "__main__":
    # compiled bytecode, torch's included, kept at a fixed place in the
    # checkout: where the installed packages carry none, or the environment
    # forbids writing it, every run would compile them all again
    sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
