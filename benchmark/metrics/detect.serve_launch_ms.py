"""Host ms per batch in the program's ``serve.launch`` span (the eager enqueue of the detect program)."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "serve.launch")
