"""Replays of the captured rollout window (instances of the program's
``rollout.replay`` span) over the profiled stretch's batch windows, in
percent."""

from h100_bench.spans import host_us


def read(record, window, cfg):
    got = host_us(record, "rollout.replay")
    windows = None if record is None else record["work"].get("windows")
    return None if got is None or not windows else 100.0 * got[1] / windows
