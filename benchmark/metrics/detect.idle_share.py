"""Share of the traced detect window with nothing running on the device (%)."""

from benchmark.harness import readers


def read(rec):
    return readers.idle_share(rec)
