"""Device ms per step of the NCCL all-reduce kernels (the gradients' and the loss's count of positives) in rank 0's traced window."""

from benchmark.harness import comm


def read(rec):
    return comm.device_ms_per_step(rec)
