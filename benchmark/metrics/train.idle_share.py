"""Share of the traced training window with nothing running on the device (%)."""

from benchmark.harness import readers


def read(rec):
    return readers.idle_share(rec)
