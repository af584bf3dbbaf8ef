"""Host ms per batch in the program's ``serve.prepare`` span (``prepare_batch``: resize and pad on the host)."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "serve.prepare")
