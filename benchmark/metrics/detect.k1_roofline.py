"""K1 (greedy NMS, kernels nms_*_kernel): the least time of a call over its device time per call (%)."""

from benchmark.harness import readers


def read(rec):
    return readers.kernel_roofline(rec, r"nms_\w+_kernel", "k1")
