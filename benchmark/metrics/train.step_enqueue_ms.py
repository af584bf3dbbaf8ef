"""Host ms per step in the program's ``train.step`` span: the step's enqueue on the host."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "train.step")
