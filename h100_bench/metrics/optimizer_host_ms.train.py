"""Host milliseconds a fleet step in the program's ``step.optimizer`` span
(the zero gradients of unused leaves and Adam-L2's step), over the
profiled steps."""

from h100_bench.spans import ms_per_unit


def read(record, window, cfg):
    return ms_per_unit(record, "step.optimizer", "steps")
