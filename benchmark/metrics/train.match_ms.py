"""Host ms per step in the program's ``train.match`` span (``match_batch``: K2 and its epilogue)."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "train.match")
