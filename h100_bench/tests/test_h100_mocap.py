"""The mocap cell (``egno-mocap.run-train``) on the CPU at a tiny size: a
run through ``run.run`` reads ``correct``, and with a fault planted in the
program it reads false; in a copy of the harness without the cell's
files, the cell needs only its new files and changes none that was there;
the samples and graph the reference takes are the program's dataset's,
bit for bit; the counts at the mocap shape; and the cell's two readers on
a recorded stretch."""

import hashlib
import json
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from h100_bench import run, spans, trace
from h100_bench.counts import egno, egno_mocap, pairwise

from nonode_tpu_torch.data.motion import MotionDynamicsDataset
from nonode_tpu_torch.motion_main import MotionExperiment

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "h100_bench"
CELL = "egno-mocap.run-train"
SMALL = {"cfg": {"nf": 16, "n_layers": 2, "batch_size": 6,
                 "max_training_samples": 30, "max_valid_samples": 18}}
# the files the cell added to the harness
NEW = ("configs/egno-mocap.json", "traffic/run-train.py",
       "traffic/run-train.json", "reference/egno_mocap.py",
       "counts/egno_mocap.py", "limits/egno-mocap.run-train.json",
       "metrics/batch_host_ms.train.py",
       "metrics/tile_calls_per_step.train.py")
MIX = run.mix_module("run-train")


def _run(tmp_path, seed=2**31 + 11, traced=False, here=HERE):
    return run.run(run.load_manifest(), CELL, seed, 0.1, traced,
                   torch.device("cpu"), t0=time.perf_counter(),
                   overrides=dict(SMALL, cfg_dir=tmp_path), here=here)


def test_an_unbroken_run_is_correct(tmp_path):
    result = _run(tmp_path, traced=True)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"train_loss", "grad_norm",
                                     "update_norm", "val_loss"}
    json.dumps(result, allow_nan=False)


def _batch_fault(monkeypatch, change):
    """Every batch of the program's experiment passed through ``change``
    (x0, v0, nodes, xt, edge_attr, edge_mask) -> the same."""
    batch = MotionExperiment.batch

    def changed(self, *a, **k):
        return change(*batch(self, *a, **k))

    monkeypatch.setattr(MotionExperiment, "batch", changed)


def _half(x0, v0, nodes, xt, attr, mask):
    b = len(x0) // 2
    return x0[:b], v0[:b], nodes[:b], xt[:b], attr, mask


def _complete(x0, v0, nodes, xt, attr, mask):
    n = mask.shape[-1]
    return x0, v0, nodes, xt, attr, 1.0 - torch.eye(n, dtype=mask.dtype)


def _swapped(x0, v0, nodes, xt, attr, mask):
    return x0, v0, nodes, xt, torch.where(attr > 0, 3.0 - attr, attr), mask


def _unchanged(monkeypatch):
    """Adam's step runs and its state moves; the parameters are put back."""
    step = torch.optim.Adam.step

    def restoring(self, *a, **k):
        params = [p for g in self.param_groups for p in g["params"]]
        keep = [p.detach().clone() for p in params]
        out = step(self, *a, **k)
        with torch.no_grad():
            for p, old in zip(params, keep):
                p.copy_(old)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", restoring)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "complete_graph", "swapped_edge_attr"])
def test_a_broken_run_is_not_correct(fault, tmp_path, monkeypatch):
    if fault == "unchanged":
        _unchanged(monkeypatch)
    else:
        _batch_fault(monkeypatch, {"half_batch": _half,
                                   "complete_graph": _complete,
                                   "swapped_edge_attr": _swapped}[fault])
    result = _run(tmp_path)
    assert not result["correct"], result["checks"]


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_the_cell_needs_only_new_files(tmp_path):
    """The harness as it was without the cell (its files taken out of a
    copy), the cell's files put back, a run of it: no file that was there
    changes, and the cell's files are all it added."""
    copy = tmp_path / "checkout" / "h100_bench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    added = {p: (copy / p).read_bytes() for p in NEW}
    for p in NEW:
        (copy / p).unlink()
    before = _digests(copy)
    for p, data in added.items():
        (copy / p).write_bytes(data)
    result = _run(tmp_path, here=copy)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    after = _digests(copy)
    assert all(after[p] == d for p, d in before.items()), \
        "an existing file was changed"
    assert set(after) - set(before) == {Path(p) for p in NEW}


def test_the_references_samples_are_the_programs(tmp_path):
    cfg = json.loads((HERE / "configs" / "egno-mocap.json").read_text())
    edges, trials = chip_smoke.write_mocap_case(tmp_path, seed=3)
    attr, mask = MIX._graph(edges, cfg["n_node"])
    assert int(mask.sum()) == cfg["mask_pairs"] == 130
    for part, key, cap in ((0, "train", cfg["max_training_samples"]),
                           (1, "val", cfg["max_valid_samples"])):
        ds = MotionDynamicsDataset(
            data_dir=tmp_path, partition=key, max_samples=cap,
            delta_frame=cfg["delta_frame"], case=cfg["case"],
            num_timesteps=cfg["num_timesteps"])
        split = pickle.loads((tmp_path / "split_run.pkl").read_bytes())
        got = MIX._samples(cfg, trials, split[part], cap)
        for name, want in (("x0", ds.x_0), ("v0", ds.v_0), ("xt", ds.x_t)):
            np.testing.assert_array_equal(got[name], want.numpy())
        np.testing.assert_array_equal(attr, ds.edge_attr.numpy())
        np.testing.assert_array_equal(mask, ds.edge_mask.numpy())
    assert len(MIX._samples(cfg, trials, split[0], 200)["x0"]) == 200


def test_counts_at_the_mocap_shape():
    cfg = json.loads((HERE / "configs" / "egno-mocap.json").read_text())
    (calls, call), = egno_mocap.pairwise_calls(cfg, cfg["batch_size"])
    assert calls == 6 and call == pairwise.Call(g=60, n=31, kept=130, h=128,
                                                e=1)
    assert call.edges == 7800
    # a complete graph's count is EGNO's on N-body graphs of N nodes
    full = dict(cfg, mask_pairs=31 * 30, n_balls=31)
    assert egno_mocap.forward_flops(full, 12) == egno.forward_flops(full, 12)
    # 930 - 130 pairs left out of each layer's edge terms, per frame
    h, e = 128, 1
    per_edge = 2 * ((1 + e) * h + 2 * h * h + h)
    assert egno.forward_flops(full, 1) - egno_mocap.forward_flops(cfg, 1) \
        == 6 * 5 * (930 - 130) * per_edge
    assert egno_mocap.train_flops(cfg, 12) == \
        3 * egno_mocap.forward_flops(cfg, 12)
    # the least times of a call at this shape, by the tile routes' counts:
    # microseconds, against the tenths of a millisecond the kernels take
    fwd, _ = pairwise.bound_s(call)
    bwd, _ = pairwise.bound_s(call, backward=True)
    assert 1e-7 < fwd < 1e-5 and 1e-7 < bwd < 1e-5


def _record():
    """Two profiled steps: a ``step.batch`` a step (one nested in another
    of its name), and the tile counters' difference in the work."""
    p = spans.PREFIX
    host = [(trace.SPAN + "train_epoch", 0.0, 3000.0),
            (p + "step.batch", 100.0, 160.0),
            (p + "step.batch", 110.0, 120.0),
            (p + "step.forward", 160.0, 900.0),
            (p + "step.batch", 1100.0, 1140.0),
            (p + "step.forward", 1140.0, 1900.0)]
    return {"wall_s": 3e-3, "device": [("k", 0.0, 10.0)], "host": host,
            "work": {"steps": 2, "tile_calls": 24}}


def _read(name, record):
    return run.metric_reader(name).read(record=record, window={}, cfg={})


def test_the_cells_readers_on_a_recorded_stretch():
    r = _record()
    assert _read("batch_host_ms.train", r) == pytest.approx(0.05)
    assert _read("tile_calls_per_step.train", r) == 12.0
    # a program without the span or the counters: the metrics stay out
    bare = dict(r, host=[h for h in r["host"] if "step.batch" not in h[0]],
                work={"steps": 2})
    assert _read("batch_host_ms.train", bare) is None
    assert _read("tile_calls_per_step.train", bare) is None
    assert _read("tile_calls_per_step.train", None) is None


@pytest.mark.cuda
def test_the_control_and_the_faults_fail_the_limits_on_the_card():
    """At the cell's own size: the program passes its limits, and the
    reference with TF32 products and each fault planted in it fail at
    least one of them."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need the card")
    from h100_bench import calibrate

    limits = run.limits_of(CELL)
    readings = list(calibrate.readings(run.load_manifest(), CELL, [7001],
                                       {7001}, torch.device("cuda", 0)))
    by = {r["side"]: r for r in readings}
    assert set(by) == {"program", "control", "half_batch", "complete_graph",
                       "swapped_edge_attr"}
    assert all(by["program"][k] <= v for k, v in limits.items())
    for side, reading in by.items():
        if side != "program":
            assert any(reading[k] is None or reading[k] > v
                       for k, v in limits.items()), side
