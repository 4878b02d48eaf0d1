"""The reduction of a traced stretch (``h100_bench/trace.py``) and the
per-layer readers on a record written by hand: device time, launches,
idle share, the longest device operations and the idle gaps by what the
host was doing, the rooflines and ``mfu``; a reader with nothing to read
returns None."""

import pytest

from h100_bench import readers, run, trace
from h100_bench.counts import PEAKS, pairwise

CALL = pairwise.Call(g=2560, n=5, kept=20, h=64, e=2)


def _record():
    # times in microseconds; the host: a span of the benchmark's over
    # everything, an op inside it from 100 to 400
    return {"wall_s": 1e-3,
            "device": [("egnn_pairwise_fwd_kernel<64>", 0.0, 50.0),
                       ("gemm", 60.0, 40.0),
                       ("egnn_pairwise_fwd_kernel<64>", 500.0, 50.0),
                       ("egnn_pairwise_bwd_kernel<64>", 900.0, 100.0)],
            "host": [(trace.SPAN + "train_epoch", 0.0, 1000.0),
                     ("aten::linear", 100.0, 400.0)],
            "work": {"steps": 2, "pairwise_fwd": [(4, CALL)],
                     "pairwise_bwd": [(2, CALL)]}}


def test_device_time_launches_and_idle():
    r = _record()
    assert trace.busy_s(r) == pytest.approx(240e-6)
    assert trace.launches(r) == 4
    assert trace.idle_share(r) == pytest.approx(1 - 0.24)
    assert trace.seconds_of(r, readers.PAIRWISE_FWD) == (
        pytest.approx(100e-6), 2)
    assert trace.top_device_ops(r)[0] == [
        "egnn_pairwise_fwd_kernel<64>", pytest.approx(100e-6)]


def test_idle_gaps_are_named_by_the_host():
    gaps = dict((k, v) for k, v in trace.idle_gaps(_record()))
    # the gap 100-500 has its middle (300) inside aten::linear; 50-60 and
    # 550-900 have theirs (55, 725) outside it
    assert gaps == {"train_epoch / aten::linear": pytest.approx(400e-6),
                    "train_epoch / python": pytest.approx(360e-6)}


def test_readers():
    r = _record()
    assert readers.per_unit_launches(r, "steps") == 2
    assert readers.per_unit_launches(r, "windows") is None
    assert readers.idle_percent(r) == pytest.approx(76.0)
    fwd = 4 * pairwise.bound_s(CALL)[0] / 100e-6
    assert readers.roofline_percent(r, "pairwise_fwd",
                                    readers.PAIRWISE_FWD) == \
        pytest.approx(100 * fwd)
    bwd = 2 * pairwise.bound_s(CALL, True)[0] / 100e-6
    assert readers.roofline_percent(r, "pairwise_bwd", readers.PAIRWISE_BWD,
                                    backward=True) == pytest.approx(100 * bwd)
    assert readers.mfu_percent({"flops": 495e12, "wall_s": 4.0}) == \
        pytest.approx(25.0)
    assert PEAKS["tf32_flops"] == 495e12


def test_a_reader_with_nothing_to_read_returns_none():
    empty = dict(_record(), device=[])
    for name in ("launches_per_step.train", "idle_share.train",
                 "pairwise_fwd_roofline.train", "pairwise_bwd_roofline.train",
                 "launches_per_window.rollout", "idle_share.rollout",
                 "pairwise_fwd_roofline.rollout"):
        reader = run.metric_reader(name)
        assert reader.read(record=None, window={}, cfg={}) is None
        assert reader.read(record=empty, window={}, cfg={}) is None
    assert run.metric_reader("mfu.train").read(None, {}, {}) is None
