"""Host ms per batch in the program's ``data.wait`` span (``Loader.device_batches``' wait for a batch), the inside counterpart of train.loader_wait_ms."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "data.wait")
