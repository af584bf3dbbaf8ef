"""Share (%) of the program's frozen BatchNorm applications made by its fused kernel K3: the counter ``bn.fused`` over ``bn.frozen``, since the process started."""

from benchmark.harness import program


def read(rec):
    snap = program.snapshot(rec)
    if snap is None:
        return None
    counters = snap["counters"]
    if not counters.get("bn.frozen"):
        return None
    return counters.get("bn.fused", 0) / counters["bn.frozen"] * 100.0
