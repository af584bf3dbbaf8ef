"""Host ms per batch in the program's ``serve.readback`` span (the wait for the device, the copies back, the unpad)."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "serve.readback")
