"""BENCHMARK.json against the rules the harness relies on: names and
units in the allowed characters, every ``moves`` reported where its metric
is, every configuration, mix, metric and cell resolving to its files by
name; and, in a copy, a new configuration, mix, metric and cell added as
new files and entries only, run without an edit to any file there was."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from h100_bench import run

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "h100_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return run.load_manifest(ROOT)


def test_names_and_units_use_the_allowed_characters(manifest):
    names = [c["name"] for c in manifest["configs"]]
    names += [w[k] for w in manifest["workloads"]
              for k in ("name", "config", "traffic")]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = [e["name"] for e in manifest[kind]]
        assert len(entries) == len(set(entries)), kind
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def test_every_moves_is_reported_in_each_cell_of_its_metric(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), \
                (m["name"], cell)
    for cell in cells:
        reported = run.cell_metrics(manifest, cell, "end_to_end")
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert run.cell_metrics(manifest, cell, "per_layer")


def test_everything_resolves_to_its_files_by_name(manifest):
    for c in manifest["configs"]:
        assert c["file"] == f"h100_bench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (HERE / "reference" / f"{cfg['model']}.py").exists()
        assert (HERE / "counts" / f"{cfg['model']}.py").exists()
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in manifest["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.py").exists()
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        mix = run.mix_module(w["traffic"])
        for fn in ("setup", "window", "stretch", "release",
                   "reference_run", "gaps", "faults"):
            assert callable(getattr(mix, fn)), (w["traffic"], fn)
        limits = run.limits_of(w["name"])
        assert limits and all(v >= 0 for v in limits.values())
    for m in manifest["per_layer"]:
        assert callable(run.metric_reader(m["name"]).read)
    assert manifest["paths"] == ["h100_bench"]
    assert manifest["command"][1:] == ["-m", "h100_bench.run"]


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_config_mix_metric_and_cell_need_only_new_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(HERE, copy / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy)
    here = copy / "h100_bench"
    cfg = json.loads((here / "configs" / "segno-charged5.json").read_text())
    cfg.update(num_train=32, num_valid=16, num_test=16, max_samples=32,
               batch_size=8, traj_len=2, length_test=5200)
    (here / "configs" / "segno-tiny.json").write_text(json.dumps(cfg))
    (here / "traffic" / "short-rollout.json").write_text(
        json.dumps({"profiled_calls": 1}))
    # a mix of its own that takes the test evaluation's steps as they are
    (here / "traffic" / "short-rollout.py").write_text(
        "from h100_bench import run\n"
        "_base = run.mix_module('test-rollout')\n"
        "setup, window, stretch = _base.setup, _base.window, _base.stretch\n"
        "release, reference_run = _base.release, _base.reference_run\n"
        "gaps, faults = _base.gaps, _base.faults\n")
    (here / "metrics" / "window_units.rollout.py").write_text(
        "def read(record, window, cfg):\n"
        "    return float(len(window['unit_ends']))\n")
    (here / "limits" / "segno-tiny.short-rollout.json").write_text(
        json.dumps({"preds": 40.0, "energy": 250.0, "artifact": 0.0}))
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "segno-tiny", "source": cfg["source"],
         "file": "h100_bench/configs/segno-tiny.json", "reduced": [],
         "why": "a test's configuration"})
    cell = "segno-tiny.short-rollout"
    manifest["workloads"].append(
        {"name": cell, "config": "segno-tiny", "traffic": "short-rollout",
         "chips": 1, "why": "a test's cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "rollout_windows_per_s":
            m["workloads"].append(cell)
    manifest["per_layer"].append(
        {"name": "window_units.rollout", "unit": "units", "better": "higher",
         "source": "host_clock", "layer": "rollout",
         "moves": "rollout_windows_per_s", "workloads": [cell]})
    untraced = run.run(manifest, cell, 11, 0.2, False, torch.device("cpu"),
                       here=here)
    traced = run.run(manifest, cell, 12, 0.2, True, torch.device("cpu"),
                     here=here)
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"rollout_windows_per_s", "setup_s"}
    assert traced["metrics"]["window_units.rollout"]["value"] >= 1
    after = _digests(copy)
    assert all(after[p] == d for p, d in before.items()), \
        "an existing file was changed"
