"""The detect window's model FLOPs per second of device busy time over the bf16 dense peak (%)."""

from benchmark.harness import readers


def read(rec):
    return readers.mfu(rec)
