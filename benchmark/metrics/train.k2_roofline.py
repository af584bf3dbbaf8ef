"""K2 (anchor matching, match_anchors_kernel): the least time of a launch at the step's valid GTs over its device time per launch (%)."""

from benchmark.harness import readers


def read(rec):
    return readers.kernel_roofline(rec, r"match_anchors_kernel", "k2")
