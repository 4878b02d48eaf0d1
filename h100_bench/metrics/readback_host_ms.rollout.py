"""Host milliseconds in the program's ``rollout.readback`` span (a batch's
loss and correlation read and its frames, targets and energies copied to
the host) over the profiled call, divided by its batch windows."""

from h100_bench.spans import ms_per_unit


def read(record, window, cfg):
    return ms_per_unit(record, "rollout.readback", "windows")
