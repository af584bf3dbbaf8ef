"""Share (%) of the traced window's batches whose detect was one CUDA graph replay: the program's ``serve.graph_replays`` counter over its ``serve.launch`` spans."""

from benchmark.harness import program


def read(rec):
    snap = program.snapshot(rec)
    if snap is None or "serve.graph_replays" not in snap["counters"]:
        return None
    launches = len(program.spans(rec, "serve.launch"))
    return snap["counters"]["serve.graph_replays"] / launches * 100.0 if launches else None
