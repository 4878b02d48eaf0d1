"""Host milliseconds a fleet step in the program's ``step.forward`` span
(the seeds' vmapped loss and its batch gather), over the profiled steps."""

from h100_bench.spans import ms_per_unit


def read(record, window, cfg):
    return ms_per_unit(record, "step.forward", "steps")
