"""Kernel #1 (the pairwise chain's forward) over the profiled stretch: the
least time of its calls at their shapes over its device time, in
percent."""

from h100_bench.readers import PAIRWISE_FWD, roofline_percent


def read(record, window, cfg):
    return roofline_percent(record, "pairwise_fwd", PAIRWISE_FWD)
