"""Host ms per step that the loop waits in next() on the loader's device batches."""

from benchmark.harness import readers


def read(rec):
    return readers.span_ms(rec, "train.loader_wait")
