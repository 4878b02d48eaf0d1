"""The reader of ``graph_replay_share.train`` on the hand-written train
record of ``test_h100_spans``: instances of the program's ``step.replay``
span (one inside each replayed step's ``step.forward``) over the
stretch's steps, in percent; None without a replay (the eager program, a
program without spans) or without steps."""

import pytest

from h100_bench.tests.test_h100_spans import P, _read, _train_record

NAME = "graph_replay_share.train"


def test_the_replay_share_counts_replays_over_steps():
    r = _train_record()
    one = dict(r, host=r["host"] + [(P + "step.replay", 1120.0, 1290.0)])
    assert _read(NAME, one) == pytest.approx(50.0)
    both = dict(one, host=one["host"] + [(P + "step.replay", 110.0, 290.0)])
    assert _read(NAME, both) == pytest.approx(100.0)


def test_the_replay_share_without_replays_or_steps_reads_none():
    r = _train_record()
    replayed = dict(r, host=r["host"] + [(P + "step.replay", 110.0, 290.0)])
    assert _read(NAME, r) is None
    assert _read(NAME, None) is None
    assert _read(NAME, dict(replayed, work={})) is None
