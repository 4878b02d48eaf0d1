"""What the per-layer metric readers share: each reader in
``metrics/<name>.py`` applies one of these to the traced run's record (the
profiled stretch, ``trace.capture``) or to its untraced window. A reader
that finds nothing to read returns None, and the metric is left out of the
result line."""

from __future__ import annotations

from h100_bench import trace
from h100_bench.counts import PEAKS, pairwise

# the device operations of the program's kernels, by name
PAIRWISE_FWD = ("egnn_pairwise_fwd", "egnn_fwd_split")
PAIRWISE_BWD = ("egnn_pairwise_bwd", "egnn_split_weights")


def per_unit_launches(record, unit):
    """Device operations of the stretch a unit of its work (``steps``,
    ``windows``)."""
    if record is None or not record["device"] or not record["work"].get(unit):
        return None
    return trace.launches(record) / record["work"][unit]


def idle_percent(record):
    if record is None or not record["device"]:
        return None
    return 100.0 * trace.idle_share(record)


def mfu_percent(window):
    """The untraced window's useful products over its wall, as a share of
    the TF32 tensor-core peak."""
    if not window.get("flops") or not window.get("wall_s"):
        return None
    return 100.0 * window["flops"] / window["wall_s"] / PEAKS["tf32_flops"]


def roofline_percent(record, key, kernels, backward=False):
    """The least time of the stretch's chain calls (``record['work'][key]``,
    [(calls, Call)]) over the device time of the kernels named
    ``kernels``, in percent."""
    if record is None or not record["work"].get(key):
        return None
    seconds, count = trace.seconds_of(record, kernels)
    if not count:
        return None
    bound = sum(calls * pairwise.bound_s(call, backward)[0]
                for calls, call in record["work"][key])
    return 100.0 * bound / seconds
