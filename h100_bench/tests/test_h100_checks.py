"""The comparison that decides ``correct`` fails where it should. A run
of each mix drives the program at a small size on the CPU (past the
runner's look for a card) with its timed path broken underneath, once for
each fault the cell can have, and ``correct`` comes out false; unbroken,
it comes out true. One chip has no exchange between chips to leave out.

The control, the reference computed with TF32 products in the program's
place, is read on the card at the cells' own size (``cuda``: skips
without one); ``h100_bench.calibrate`` takes the same readings over many
seeds for the limits, with each fault planted in the reference put in
the program's place. A rollout restarted past window 8 shows only where
the state it replaces is finite, which at random weights depends on the
seed; planted in the program, it is caught here below."""

import json
import time

import numpy as np
import pytest
import torch

from h100_bench import calibrate, run

from nonode_tpu_torch.train.loop import EGNOExperiment, SEGNOExperiment

SMALL = {"cfg": {"num_train": 48, "num_valid": 16, "num_test": 32,
                 "max_samples": 48, "batch_size": 16, "traj_len": 10,
                 "length_test": 13200, "test_interval": 2}}


def _run(cell, tmp_path, seed=3):
    small = dict(SMALL, cfg_dir=tmp_path)
    return run.run(run.load_manifest(), cell, seed, 0.1, False,
                   torch.device("cpu"), t0=time.perf_counter(),
                   overrides=small)


def _unchanged_state(monkeypatch):
    """Adam's step runs and its state moves; the parameters are put back."""
    step = torch.optim.Adam.step

    def restoring(self, *a, **k):
        keep = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        out = step(self, *a, **k)
        with torch.no_grad():
            for p, old in zip((p for g in self.param_groups
                               for p in g["params"]), keep):
                p.copy_(old)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", restoring)


def _half_batch_loss(monkeypatch, cls):
    """Every training batch cut to its first half: the mean is over the
    rest."""
    batch = cls.batch

    def half(self, *a, **k):
        out = batch(self, *a, **k)
        return tuple(t[: t.shape[0] // 2] if torch.is_tensor(t) else t
                     for t in out)

    monkeypatch.setattr(cls, "batch", half)


def _stuck_rollout(monkeypatch, cls):
    """Every window of a rollout starts from the first window's input."""
    rollout = cls.rollout

    def stuck(self, batch, traj_len, kind):
        x, e = rollout(self, batch, 1, kind)
        return (x.repeat(traj_len, *([1] * (x.dim() - 1))),
                e.repeat(traj_len, *([1] * (e.dim() - 1))))

    monkeypatch.setattr(cls, "rollout", stuck)


def _restarted_rollout(monkeypatch, cls):
    """Past the windows an EGNO evaluation keeps (or past half of them),
    the rollout's windows start again from the input: a state fed back
    wrong only where the artifact no longer looks."""
    rollout = cls.rollout

    def restarted(self, batch, traj_len, kind):
        kept = min(int(0.4 * traj_len), traj_len // 2)
        x, e = rollout(self, batch, kept, kind)
        frames = x.shape[0] // kept * traj_len
        reps = -(-traj_len // kept)
        return torch.cat([x] * reps)[:frames], torch.cat([e] * reps)[:frames]

    monkeypatch.setattr(cls, "rollout", restarted)


def _short_rollout(monkeypatch, cls):
    """The rollout stops after the windows an EGNO evaluation keeps."""
    rollout = cls.rollout

    def short(self, batch, traj_len, kind):
        return rollout(self, batch, int(0.4 * traj_len), kind)

    monkeypatch.setattr(cls, "rollout", short)


def _half_batch_rollout(monkeypatch, cls):
    """The test evaluation leaves out the second half of every batch and
    takes its loss over the rest."""
    test_rollout = cls.test_rollout

    def half(self, ds, batch_size, rng):
        _, steps, art = test_rollout(self, ds, batch_size, rng)
        keep = np.concatenate([np.arange(s, s + batch_size // 2) for s in
                               range(0, len(art["preds"]), batch_size)])
        art = {k: (v[keep] if isinstance(v, np.ndarray) else v)
               for k, v in art.items()}
        frames = art["preds"].shape[1]
        art["test_loss"] = float(np.mean(
            (art["preds"] - art["targets"][:, :frames]) ** 2))
        return art["test_loss"], steps, art

    monkeypatch.setattr(cls, "test_rollout", half)


def _altered_answer(monkeypatch, cls):
    """One sample's answer moved where the rollout makes it."""
    rollout = cls.rollout

    def altered(self, batch, traj_len, kind):
        x, e = rollout(self, batch, traj_len, kind)
        x = x.clone()
        x[0, 3] += 1.0
        return x, e

    monkeypatch.setattr(cls, "rollout", altered)


@pytest.mark.parametrize("cell", ["egno-charged5.fleet5-train",
                                  "egno-charged5.test-rollout",
                                  "segno-charged5.test-rollout"])
def test_an_unbroken_run_is_correct(cell, tmp_path):
    result = _run(cell, tmp_path)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("cell,cls,fault", [
    ("egno-charged5.fleet5-train", EGNOExperiment, "unchanged"),
    ("egno-charged5.fleet5-train", EGNOExperiment, "half"),
    ("segno-charged5.fleet5-train", SEGNOExperiment, "half"),
    ("egno-charged5.test-rollout", EGNOExperiment, "stuck"),
    ("egno-charged5.test-rollout", EGNOExperiment, "half_rollout"),
    ("egno-charged5.test-rollout", EGNOExperiment, "altered"),
    ("egno-charged5.test-rollout", EGNOExperiment, "restarted"),
    ("egno-charged5.test-rollout", EGNOExperiment, "short"),
    ("segno-charged5.test-rollout", SEGNOExperiment, "stuck"),
    ("segno-charged5.test-rollout", SEGNOExperiment, "altered"),
])
def test_a_broken_run_is_not_correct(cell, cls, fault, tmp_path,
                                     monkeypatch):
    plant = {"unchanged": lambda: _unchanged_state(monkeypatch),
             "half": lambda: _half_batch_loss(monkeypatch, cls),
             "stuck": lambda: _stuck_rollout(monkeypatch, cls),
             "half_rollout": lambda: _half_batch_rollout(monkeypatch, cls),
             "altered": lambda: _altered_answer(monkeypatch, cls),
             "restarted": lambda: _restarted_rollout(monkeypatch, cls),
             "short": lambda: _short_rollout(monkeypatch, cls)}
    plant[fault]()
    result = _run(cell, tmp_path)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["egno-charged5.fleet5-train",
                                  "segno-charged5.fleet5-train",
                                  "egno-charged5.test-rollout",
                                  "segno-charged5.test-rollout"])
def test_the_control_fails_the_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need the card")
    limits = run.limits_of(cell)
    readings = list(calibrate.readings(run.load_manifest(), cell, [7001],
                                       {7001}, torch.device("cuda", 0)))
    by = {r["side"]: r for r in readings}
    assert all(by["program"][k] <= v for k, v in limits.items())
    for side, reading in by.items():
        if side not in ("program", "restarted_past_kept"):
            assert any(reading.get(k, 0.0) is None
                       or reading.get(k, 0.0) > v
                       for k, v in limits.items()), side
