"""The program's spans in a traced record (``h100_bench/spans.py``) and the
nine readers of them, on records written by hand: a span nested in one of
its own name counts once, times and launches are divided by the unit of
work or the instances, launch calls count inside their span only, a reader
whose span is absent (a program without spans, or without their prefix)
returns None, and the idle time is covered, and named, by the span open at
each gap's middle."""

import bisect

import pytest

from h100_bench import run, spans, trace
from nonode_tpu_torch.utils import profiling

P = spans.PREFIX
TRAIN = ("forward_host_ms.train", "backward_host_ms.train",
         "optimizer_host_ms.train", "optimizer_launches.train",
         "pairwise_fwd_host_us.train", "pairwise_bwd_host_us.train")
ROLLOUT = ("window_host_ms.rollout", "readback_host_ms.rollout",
           "pairwise_fwd_host_us.rollout")


def _call(name, t):
    return (name, t, t + 5.0)


def _train_record():
    # times in microseconds: two steps, a step.forward nested in another in
    # the first, #2's spans inside the backward (as on autograd's thread)
    host = [(trace.SPAN + "train_epoch", 0.0, 3000.0),
            (P + "step.forward", 100.0, 300.0),
            (P + "step.forward", 150.0, 200.0),
            (P + "kernel.pairwise_fwd", 120.0, 140.0),
            (P + "step.backward", 300.0, 600.0),
            (P + "kernel.pairwise_bwd", 400.0, 450.0),
            (P + "step.optimizer", 600.0, 700.0),
            (P + "step.forward", 1100.0, 1300.0),
            (P + "kernel.pairwise_fwd", 1120.0, 1150.0),
            (P + "step.backward", 1300.0, 1600.0),
            (P + "kernel.pairwise_bwd", 1400.0, 1480.0),
            (P + "step.optimizer", 1600.0, 1800.0),
            ("aten::linear", 105.0, 110.0),
            _call("cudaLaunchKernel", 110.0),
            _call("cudaLaunchKernel", 610.0),
            _call("cudaLaunchKernelExC", 650.0),
            ("cudaStreamSynchronize", 680.0, 690.0),
            _call("cudaMemcpyAsync", 690.0),
            _call("cudaMemsetAsync", 1650.0),
            _call("cuLaunchKernel", 2000.0)]
    device = [("k", 0.0, 120.0), ("k", 200.0, 50.0), ("k", 900.0, 100.0),
              ("k", 1000.0, 10.0), ("k", 2100.0, 100.0),
              ("k", 2500.0, 100.0)]
    return {"wall_s": 3e-3, "device": device, "host": host,
            "work": {"steps": 2}}


def _rollout_record():
    host = [(trace.SPAN + "test_rollout", 0.0, 1000.0),
            (P + "rollout.window", 100.0, 200.0),
            (P + "kernel.pairwise_fwd", 110.0, 130.0),
            (P + "rollout.window", 200.0, 300.0),
            (P + "kernel.pairwise_fwd", 210.0, 240.0),
            (P + "rollout.readback", 300.0, 400.0),
            _call("cudaMemcpyAsync", 310.0)]
    return {"wall_s": 1e-3, "device": [("k", 0.0, 10.0)], "host": host,
            "work": {"windows": 2}}


def _read(name, record):
    return run.metric_reader(name).read(record=record, window={}, cfg={})


def test_nested_spans_of_one_name_count_once():
    r = _train_record()
    assert spans.instances(r, "step.forward") == [[100.0, 300.0],
                                                   [1100.0, 1300.0]]
    assert spans.host_us(r, "step.forward") == (400.0, 2)
    # spans that only touch stay two instances
    assert spans.host_us(_rollout_record(), "rollout.window") == (200.0, 2)


def test_launch_calls_count_inside_their_span_only():
    r = _train_record()
    # every launch, copy and set call; a synchronize is none
    assert sum(n in spans.LAUNCHES for n, _, _ in r["host"]) == 6
    assert spans.launches(r, "step.optimizer") == 4
    assert spans.launches(r, "step.forward") == 1
    assert spans.launches(r, "step.backward") == 0
    assert spans.launches(r, "rollout.window") is None


def test_the_train_readers_divide_by_steps_and_calls():
    r = _train_record()
    want = {"forward_host_ms.train": 0.2, "backward_host_ms.train": 0.3,
            "optimizer_host_ms.train": 0.15,
            "optimizer_launches.train": 2.0,
            "pairwise_fwd_host_us.train": 25.0,
            "pairwise_bwd_host_us.train": 65.0}
    assert {m: _read(m, r) for m in TRAIN} == pytest.approx(want)


def test_the_rollout_readers_divide_by_batch_windows_and_calls():
    r = _rollout_record()
    want = {"window_host_ms.rollout": 0.1, "readback_host_ms.rollout": 0.05,
            "pairwise_fwd_host_us.rollout": 25.0}
    assert {m: _read(m, r) for m in ROLLOUT} == pytest.approx(want)


@pytest.mark.parametrize("name", TRAIN + ROLLOUT)
def test_a_reader_without_its_span_returns_none(name):
    r = _train_record() if name.endswith(".train") else _rollout_record()
    no_spans = dict(r, host=[h for h in r["host"] if not h[0].startswith(P)])
    assert _read(name, None) is None
    assert _read(name, no_spans) is None
    if "_us." not in name:                  # divided by the unit of work
        assert _read(name, dict(r, work={})) is None


@pytest.mark.parametrize("name", TRAIN + ROLLOUT)
def test_a_program_without_the_prefix_reads_none(monkeypatch, name):
    assert spans.PREFIX == profiling.PREFIX
    r = _train_record() if name.endswith(".train") else _rollout_record()
    monkeypatch.setattr(spans, "PREFIX", None)
    assert _read(name, r) is None


def covered_idle_share(record):
    """The share of the device's idle time (the gaps between its
    operations, as ``trace.idle_gaps`` takes them) in gaps whose middle
    falls inside a span of the program; None without a gap."""
    gaps, last = [], None
    for _, start, d in record["device"]:
        if last is not None and start > last:
            gaps.append(((start + last) / 2, start - last))
        last = start + d if last is None else max(last, start + d)
    total = sum(length for _, length in gaps)
    if not total:
        return None
    merged = spans._merged((s, e) for n, s, e in record["host"]
                           if n.startswith(P))
    starts = [s for s, _ in merged]
    covered = 0.0
    for mid, length in gaps:
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid < merged[i][1]:
            covered += length
    return covered / total


def test_idle_is_covered_and_named_by_the_span_at_each_gap():
    r = _train_record()
    # gaps (start-end, middle): 120-200 (160, step.forward), 250-900 (575,
    # step.backward), 1010-2100 (1555, step.backward), 2200-2500 (2350,
    # no span); the device's 900-1000 and 1000-1010 leave no gap
    assert covered_idle_share(r) == pytest.approx(1820 / 2120)
    gaps = dict(trace.idle_gaps(r))
    assert gaps == {
        "train_epoch / nonode:step.backward": pytest.approx(1740e-6),
        "train_epoch / nonode:step.forward": pytest.approx(80e-6),
        "train_epoch / python": pytest.approx(300e-6)}
    assert covered_idle_share(dict(r, device=r["device"][:1])) is None
