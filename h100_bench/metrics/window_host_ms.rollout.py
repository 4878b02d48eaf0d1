"""Host milliseconds a batch window (one fed-back window of a test batch)
in the program's ``rollout.window`` span: the model's forward and the
feedback, over the profiled call."""

from h100_bench.spans import ms_per_unit


def read(record, window, cfg):
    return ms_per_unit(record, "rollout.window", "windows")
