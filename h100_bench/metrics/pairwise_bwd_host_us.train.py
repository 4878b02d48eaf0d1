"""Host microseconds a call of the pairwise chain's backward (#2, both its
launches) in the program's ``kernel.pairwise_bwd`` span: the autograd
node's body, the wrapper's checks, allocations and launches, over the
profiled steps."""

from h100_bench.spans import us_per_instance


def read(record, window, cfg):
    return us_per_instance(record, "kernel.pairwise_bwd")
