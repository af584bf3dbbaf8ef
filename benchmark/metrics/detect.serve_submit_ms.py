"""Host ms per batch in the program's ``serve.submit`` span (``Predictor.submit``: prepare, upload, launch), the inside counterpart of detect.submit_ms."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "serve.submit")
