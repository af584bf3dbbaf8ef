"""Host ms per batch in the program's ``serve.upload`` span (pin and the host-to-device copy's enqueue)."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "serve.upload")
