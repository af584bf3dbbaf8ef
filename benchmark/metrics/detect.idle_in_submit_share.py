"""The device's idle time inside the program's ``serve.submit`` spans over the traced window's idle time (%)."""

from benchmark.harness import program


def read(rec):
    return program.idle_in_share(rec, "serve.submit")
