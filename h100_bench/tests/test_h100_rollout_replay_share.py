"""The reader of ``graph_replay_share.rollout`` on the hand-written rollout
record of ``test_h100_spans``: instances of the program's
``rollout.replay`` span (one inside each replayed ``rollout.window``) over
the stretch's batch windows, in percent; None without a replay (the eager
program, a program without spans) or without windows."""

import pytest

from h100_bench.tests.test_h100_spans import P, _read, _rollout_record

NAME = "graph_replay_share.rollout"


def _replayed(record, *starts):
    """``record`` with a ``rollout.replay`` inside the window at each of
    ``starts``."""
    return dict(record, host=record["host"] + [
        (P + "rollout.replay", s + 5.0, s + 60.0) for s in starts])


@pytest.mark.parametrize("starts,share", [((100.0,), 50.0),
                                          ((100.0, 200.0), 100.0)])
def test_the_replay_share_counts_replays_over_windows(starts, share):
    assert _read(NAME, _replayed(_rollout_record(), *starts)) \
        == pytest.approx(share)


def test_the_replay_share_without_replays_or_windows_reads_none():
    r = _rollout_record()
    assert _read(NAME, r) is None
    assert _read(NAME, None) is None
    assert _read(NAME, dict(_replayed(r, 100.0), work={})) is None
