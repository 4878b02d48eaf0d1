"""Host milliseconds a fleet step in the program's ``step.backward`` span
(the gradients set to None, then the summed loss's backward), over the
profiled steps."""

from h100_bench.spans import ms_per_unit


def read(record, window, cfg):
    return ms_per_unit(record, "step.backward", "steps")
