"""Replays of the captured fleet step (instances of the program's
``step.replay`` span) over the profiled Adam steps, in percent."""

from h100_bench.spans import host_us


def read(record, window, cfg):
    got = host_us(record, "step.replay")
    steps = None if record is None else record["work"].get("steps")
    return None if got is None or not steps else 100.0 * got[1] / steps
