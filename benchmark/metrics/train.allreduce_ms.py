"""Host ms per step in the program's ``train.allreduce`` span: the gradients' all-reduce (pack, NCCL call, unpack) as the host enqueues it."""

from benchmark.harness import program


def read(rec):
    return program.span_ms(rec, "train.allreduce")
