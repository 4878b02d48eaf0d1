"""A bounded stretch of a run under ``torch.profiler`` and its reduction:
the device's operations (kernels, copies, sets) with their times, the
host's operations and the benchmark's own spans, and what the per-layer
metrics read from them. Device time is the sum of the device operations'
durations and the idle share 1 - device time / wall, the arithmetic of
the repository's ``chip_smoke.py:traced``."""

from __future__ import annotations

import heapq
import time
from collections import defaultdict

import torch

SPAN = "bench:"          # the prefix of the benchmark's own spans


def span(name):
    """A span of the benchmark's around a call into the program."""
    return torch.profiler.record_function(SPAN + name)


def capture(fn, device):
    """Run ``fn()`` under the profiler, closed by a device sync. Returns
    the record: ``wall_s``, ``device`` [(name, start_us, dur_us)] and
    ``host`` [(name, start_us, end_us)] of the operations, and ``work``,
    whatever ``fn`` returned."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work = fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((e.name, start, end - start))
        else:
            host.append((e.name, start, end))
    dev.sort(key=lambda d: d[1])
    return {"wall_s": wall, "device": dev, "host": host, "work": work}


def busy_s(record):
    """Seconds of device operations in the stretch."""
    return sum(d for _, _, d in record["device"]) / 1e6


def launches(record):
    """Device operations in the stretch."""
    return len(record["device"])


def idle_share(record):
    return 1.0 - busy_s(record) / record["wall_s"]


def seconds_of(record, fragments):
    """(seconds, count) of the device operations whose name holds one of
    ``fragments``."""
    hits = [d for n, _, d in record["device"]
            if any(f in n for f in fragments)]
    return sum(hits) / 1e6, len(hits)


def top_device_ops(record, n=10):
    """The ``n`` device operations that took the most time, by name:
    [[name, seconds], ...]."""
    by = defaultdict(float)
    for name, _, d in record["device"]:
        by[name] += d / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(record, n=10):
    """Device idle time by what the host was doing: every gap between the
    device's operations is named by the outermost benchmark span and the
    outermost other host operation open at its middle ("python" when
    none is: the host was between operations). Returns the ``n`` names
    with the most idle time: [[name, seconds], ...]."""
    gaps, last = [], None
    for _, start, d in record["device"]:
        if last is not None and start > last:
            gaps.append(((start + last) / 2, (start - last) / 1e6))
        last = start + d if last is None else max(last, start + d)
    gaps.sort()
    host = sorted(record["host"], key=lambda h: h[1])
    open_, i, by = [], 0, defaultdict(float)
    for mid, length in gaps:
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(open_, (host[i][2], host[i][1], host[i][0]))
            i += 1
        while open_ and open_[0][0] <= mid:
            heapq.heappop(open_)
        spans = sorted((s, nm) for end, s, nm in open_ if end > mid)
        ours = [nm for _, nm in spans if nm.startswith(SPAN)]
        other = [nm for _, nm in spans if not nm.startswith(SPAN)]
        label = " / ".join(filter(None, [
            ours[0][len(SPAN):] if ours else "",
            other[0] if other else "python"]))
        by[label] += length
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
