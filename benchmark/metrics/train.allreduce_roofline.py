"""The all-reduces' share (%) of their roofline: the ring's bus bytes of the program's ``comm.all_reduce_bytes`` over the NVLink peak, over the NCCL all-reduce kernels' device time; low under skew between the ranks (``harness/comm.py``)."""

from benchmark.harness import comm


def read(rec):
    return comm.roofline(rec)
