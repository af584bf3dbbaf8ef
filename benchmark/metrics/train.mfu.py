"""The training window's model FLOPs (3x forward) per second of device busy time over the configuration's dense peak (%)."""

from benchmark.harness import readers


def read(rec):
    return readers.mfu(rec)
