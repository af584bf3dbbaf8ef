"""Host ms per batch in the benchmark's span around ``Predictor.submit`` (prepare_batch, pinned upload, launch)."""

from benchmark.harness import readers


def read(rec):
    return readers.span_ms(rec, "detect.submit")
