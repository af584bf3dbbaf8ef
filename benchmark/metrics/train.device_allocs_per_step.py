"""Device segments the caching allocator created per step in the traced window (the program's ``mem.device_allocs`` over its ``train.step`` spans)."""

from benchmark.harness import program


def read(rec):
    return program.per_step(rec, "mem.device_allocs", "train.step")
