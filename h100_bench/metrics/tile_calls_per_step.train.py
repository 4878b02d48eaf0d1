"""Calls of the pairwise chain's kernels (#1 and #2) that took their tile
routes over the profiled steps, a step: the program's ``tile_launches``
counters, read by the mix around the stretch (``work['tile_calls']``;
absent where the program has no such counter)."""


def read(record, window, cfg):
    work = {} if record is None else record["work"]
    calls, steps = work.get("tile_calls"), work.get("steps")
    return None if calls is None or not steps else calls / steps
