"""Runtime launch calls (kernels, copies, sets) that start inside the
program's ``step.optimizer`` span, for each Adam step of the fleet."""

from h100_bench.spans import launches_per_unit


def read(record, window, cfg):
    return launches_per_unit(record, "step.optimizer", "steps")
