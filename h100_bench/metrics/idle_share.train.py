"""The device's idle share over the profiled stretch: 1 - device time /
wall, in percent."""

from h100_bench.readers import idle_percent


def read(record, window, cfg):
    return idle_percent(record)
