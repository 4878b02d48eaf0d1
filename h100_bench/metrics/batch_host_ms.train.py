"""Host milliseconds a step in the program's ``step.batch`` span (the
per-seed loop's batch assembly: ``MotionExperiment.batch``'s gathers and
node features), over the profiled steps."""

from h100_bench.spans import ms_per_unit


def read(record, window, cfg):
    return ms_per_unit(record, "step.batch", "steps")
