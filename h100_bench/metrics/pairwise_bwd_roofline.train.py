"""Kernel #2 (the pairwise chain's backward, both its launches) over the
profiled stretch: the least time of its calls at their shapes over its
device time, in percent."""

from h100_bench.readers import PAIRWISE_BWD, roofline_percent


def read(record, window, cfg):
    return roofline_percent(record, "pairwise_bwd", PAIRWISE_BWD,
                            backward=True)
