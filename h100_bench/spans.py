"""The program's own spans in a traced stretch (``trace.capture``'s
record): the ``nonode:<name>`` ranges that ``nonode_tpu_torch``'s
``utils/profiling.py:span`` opens while the profiler records, on the clock
of the device trace.

A span's host time is the union of its instances: a span inside another of
the same name counts once, and an instance is an outermost one. Its
launches are the runtime calls that enqueue a device operation
(``LAUNCHES``) and start inside it. A stretch without the span reads None,
so that a program without spans leaves the metrics that read them out of
the result line."""

from __future__ import annotations

import bisect

from nonode_tpu_torch.utils import profiling

# the program's own prefix; a program that has none opens no span
PREFIX = getattr(profiling, "PREFIX", None)
# the CUDA runtime and driver calls that enqueue a device operation
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaMemcpyAsync", "cudaMemsetAsync"))


def _merged(intervals):
    """The (start, end) ``intervals`` in order, each that overlaps the one
    before merged into it: [[start, end], ...]."""
    out = []
    for s, e in sorted(intervals):
        if out and s < out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def instances(record, name):
    """[[start_us, end_us], ...] of span ``name``, in order: each an
    outermost instance with the same-name spans inside it."""
    if PREFIX is None:
        return []
    return _merged((s, e) for n, s, e in record["host"]
                   if n == PREFIX + name)


def host_us(record, name):
    """(microseconds, instances) of span ``name`` over the stretch; None
    without a record or an instance."""
    spans = [] if record is None else instances(record, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans), len(spans)


def launches(record, name):
    """The launch calls of the stretch that start inside span ``name``;
    None where it has no instance."""
    spans = instances(record, name)
    if not spans:
        return None
    calls = sorted(s for n, s, _ in record["host"] if n in LAUNCHES)
    return sum(bisect.bisect_left(calls, e) - bisect.bisect_left(calls, s)
               for s, e in spans)


def _units(record, unit):
    return None if record is None else record["work"].get(unit)


def ms_per_unit(record, name, unit):
    """Host milliseconds in span ``name`` a unit of the stretch's work
    (``steps``, ``windows``)."""
    got, units = host_us(record, name), _units(record, unit)
    return None if got is None or not units else got[0] / 1e3 / units


def us_per_instance(record, name):
    """Host microseconds an instance of span ``name``."""
    got = host_us(record, name)
    return None if got is None else got[0] / got[1]


def launches_per_unit(record, name, unit):
    """Launch calls inside span ``name`` a unit of the stretch's work."""
    units = _units(record, unit)
    n = None if not units else launches(record, name)
    return None if n is None else n / units

