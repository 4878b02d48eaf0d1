"""Host microseconds a call of the pairwise chain's forward (#1) in the
program's ``kernel.pairwise_fwd`` span: the autograd Function, the
wrapper's checks, allocations and launch, over the profiled call."""

from h100_bench.spans import us_per_instance


def read(record, window, cfg):
    return us_per_instance(record, "kernel.pairwise_fwd")
