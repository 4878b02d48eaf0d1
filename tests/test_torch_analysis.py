"""The port's analysis layer (nonode_tpu_torch/analysis/, utils/profiling.py)
against the JAX package's.

The analysis functions are the same host-side numpy in both packages, so on
the same artifacts every value must be equal (assert_array_equal, NaN equal
to NaN), not close:
- scan_results and build_report (report.json, table.tex) on a mixed tree:
  ``.npz`` and reference ``.pt`` artifacts as tests/test_analysis.py
  writes them, plus the ledger and artifacts of a tiny port sweep;
- analyze_group, short_horizon_loss and avg_loss_until_corr on each group;
- load_ledger_groups and mean_std on the sweep's outf, with an inherited
  ledger row, and a row whose artifact is gone and whose companions come
  from the snapshot;
- a reference ``.pt`` pickle (a dict, a ``torch_geometric.data.Data``, a
  PyG-style store, SEGNO's loss/counter layout) loads through the port's
  stub as through JAX's.
PhaseTimer's counts, totals and schema equal JAX's on one clock; trace
writes a trace file on the CPU.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from nonode_tpu.analysis import ledger as jledger
from nonode_tpu.analysis import registry as jregistry
from nonode_tpu.analysis import results as jresults
from nonode_tpu.utils import profiling as jprofiling
from nonode_tpu_torch.analysis import ledger as tledger
from nonode_tpu_torch.analysis import registry as tregistry
from nonode_tpu_torch.analysis import results as tresults
from nonode_tpu_torch.compat import ref_stubs
from nonode_tpu_torch.parallel import sweep as tsweep
from nonode_tpu_torch.utils import profiling as tprofiling
from torch_port_util import write_charged_split

BASE = ("EGNO_{ds}_seed={s}_n_part=5_n_inputs=1_dT_1"
        "_varDT=False_num_timesteps=10_results.{ext}")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A mixed artifact tree: tests/test_analysis.py's (``jax/`` .npz of
    dataset ``charged_a``, an underscored value the legend must keep whole;
    ``ref/`` .pt, seeds 1-2; a ``transplant_b/`` copy that the scan skips)
    and ``port/``, a tiny sequential port sweep (EGNO and
    SEGNO, seeds 1-2, two epochs) with its ledger."""
    root = tmp_path_factory.mktemp("analysis_tree")
    rng = np.random.RandomState(0)
    for d in ("jax", "ref", "transplant_b"):
        (root / d).mkdir()
    for seed in (1, 2):
        t = rng.randn(8, 10, 5, 3)
        np.savez(root / "jax" / BASE.format(ds="charged_a", s=seed,
                                            ext="npz"),
                 targets=t, preds=t[:, :4] + 0.1,
                 energy_conservation=np.ones((8, 4, 1)), test_loss=0.25)
        ref = {"targets": torch.tensor(t),
               "preds": torch.tensor(t[:, :4] + 0.2 * rng.randn(8, 4, 5, 3)),
               "energy_conservation": torch.ones(8, 4, 1)
               + 0.01 * torch.tensor(rng.randn(8, 4, 1)),
               "test_loss": 0.5 * seed}
        name = BASE.format(ds="charged", s=seed, ext="pt")
        torch.save(ref, root / "ref" / name)
        torch.save({**ref, "test_loss": 99.0}, root / "transplant_b" / name)

    data = root / "data"
    data.mkdir()
    for seed, part in enumerate(("train", "valid", "test")):
        write_charged_split(data, part, seed=seed, s=8, f=55)
    conf = root / "tiny.yaml"
    conf.write_text("EGNO:\n  model_params: {n_layers: 2, hidden_nf: 16, "
                    "time_emb_dim: 8}\nSEGNO:\n  model_params: {hidden_nf: "
                    "16}\n")
    sched = root / "grid.json"
    sched.write_text(json.dumps({"TINY": {"method": "grid", "parameters": {
        "exp_name": {"value": "_exp_new"}, "dataset": {"value": "charged"},
        "n_balls": {"value": 5}, "num_inputs": {"value": 1},
        "varDT": {"value": False}, "model": {"values": ["egno", "segno"]},
        "seed": {"values": [1, 2]}}}}))
    outf = root / "port"
    tsweep.run_sweep("TINY", str(sched), {
        "data_dir": str(data), "outf": str(outf), "epochs": 2,
        "batch_size": 4, "traj_len": 3, "test_interval": 1,
        "config": str(conf), "device": "cpu"}, outf / "sweep_TINY.jsonl")
    return root


def _assert_equal_trees(a, b):
    """Equal dicts of arrays and scalars, NaN equal to NaN."""
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_scan_and_report_equal_jax(tree, tmp_path):
    reg = tregistry.scan_results(tree)
    assert reg == jregistry.scan_results(tree)
    # jax/, ref/ and the port sweep's two models; transplant_b/ skipped
    assert len(reg) == 4
    assert not any("transplant" in p for g in reg.values() for p in g.values())
    assert tregistry.scan_results(tree, exclude=()) == \
        jregistry.scan_results(tree, exclude=())

    port = tregistry.build_report(tree, tmp_path / "port")
    jax_out = jregistry.build_report(tree, tmp_path / "jax")
    assert json.dumps(port) == json.dumps(jax_out)
    for name in ("report.json", "table.tex"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert port["latex"].count(r"\\") == 1 + len(reg)
    assert (tmp_path / "port" / "mse_curves.png").exists()


def test_report_is_written_without_a_figure(tree, tmp_path, monkeypatch,
                                            capsys):
    """Where matplotlib is missing (the card's machine), the report and the
    table are written and plotting is skipped with a message."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tregistry.build_report(tree, tmp_path)
    assert "plotting skipped" in capsys.readouterr().out
    assert not (tmp_path / "mse_curves.png").exists()
    assert json.loads((tmp_path / "report.json").read_text())["latex"] == \
        out["latex"]
    assert (tmp_path / "table.tex").read_text() == out["latex"]


def test_registry_cli_prints_each_group(tree, tmp_path, capsys):
    tregistry.main(["--results", str(tree), "--out", str(tmp_path)])
    port = capsys.readouterr().out
    jregistry.main(["--results", str(tree), "--out", str(tmp_path / "j")])
    assert port == capsys.readouterr().out
    assert port.count("test_loss") == 4


def test_group_analysis_equals_jax(tree):
    for key, seeds in tregistry.scan_results(tree).items():
        paths = list(seeds.values())
        _assert_equal_trees(tresults.analyze_group(paths),
                            jresults.analyze_group(paths))
        agg = tresults.analyze_group(paths)
        for threshold in (0.99, 0.5, -2.0):      # -2: never drops below
            np.testing.assert_array_equal(
                tresults.avg_loss_until_corr(agg["mse_mean"],
                                             agg["corr_mean"], threshold),
                jresults.avg_loss_until_corr(agg["mse_mean"],
                                             agg["corr_mean"], threshold))
        for p in paths:
            art = tresults.load_artifact(p)
            _assert_equal_trees(art, jresults.load_artifact(p))
            for h, fpe in ((20, 1), (20, 10), (2, 1), (5, 2)):
                np.testing.assert_array_equal(
                    tresults.short_horizon_loss(art, h, fpe),
                    jresults.short_horizon_loss(art, h, fpe))
            for fn in ("mse_per_timestep", "mae_per_timestep",
                       "correlation_per_timestep"):
                np.testing.assert_array_equal(
                    getattr(tresults, fn)(art["targets"], art["preds"]),
                    getattr(jresults, fn)(art["targets"], art["preds"]))
            np.testing.assert_array_equal(
                tresults.energy_drift_per_timestep(
                    art["energy_conservation"]),
                jresults.energy_drift_per_timestep(
                    art["energy_conservation"]))
    assert tresults.latex_table([("a b", 0.5, 0.25)], "C", "L") == \
        jresults.latex_table([("a b", 0.5, 0.25)], "C", "L")


def test_ledger_groups_equal_jax(tree, tmp_path):
    """The port sweep's outf, copied with a sibling ledger that inherits
    one row and adds a row whose artifact is gone (its companions from the
    snapshot)."""
    import shutil

    outf = tmp_path / "outf"
    shutil.copytree(tree / "port", outf)
    rows = [json.loads(line) for line in
            (outf / "sweep_TINY.jsonl").read_text().splitlines()]
    gone = json.loads(json.dumps(rows[0]))
    gone["config"]["seed"] = 7
    gone["config_id"] = tsweep.config_id(gone["config"])
    (outf / "sweep_XTRA.jsonl").write_text(
        json.dumps(rows[1]) + "\n" + json.dumps(gone) + "\n")
    (outf / "companions.jsonl").write_text(json.dumps(
        {"config_id": gone["config_id"], "ff": 0.5, "tlf": 1.5, "h20": 2.5,
         "ff20": 0.75}) + "\n" + json.dumps(
        {"kind": "group", "key": ["egno", "charged", 5, 1, False],
         "val": 1.0}) + "\n")

    port = tledger.load_ledger_groups(outf)
    jax_groups = jledger.load_ledger_groups(outf)
    assert list(port) == list(jax_groups)
    assert [len(v) for v in port.values()] == [3, 2]
    for key in port:
        assert len(port[key]) == len(jax_groups[key])
        for a, b in zip(port[key], jax_groups[key]):
            _assert_equal_trees(a, b)
        for field in ("val", "test", "h20"):
            vals = [r[field] for r in port[key]]
            assert tledger.mean_std(vals) == jledger.mean_std(vals)
    assert tledger.load_companions(outf) == jledger.load_companions(outf)
    assert [r for r, _, _ in tledger.iter_ledger_artifacts(outf)] == \
        [r for r, _, _ in jledger.iter_ledger_artifacts(outf)]


# ---------- reference pickles ----------

class _FakeStorage:
    """PyG's BaseStorage keeps its keys in _mapping, not __dict__."""

    def __init__(self, mapping):
        self._mapping = mapping


class _FakePyGData:
    def __init__(self, mapping):
        self._store = _FakeStorage(mapping)


TG = ("torch_geometric", "torch_geometric.data")


def _forget(monkeypatch, names):
    """Remove modules from sys.modules for the test; the fixture restores
    the state before it."""
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)
        del sys.modules[name]


def _save_as_torch_geometric_data(path, fields, monkeypatch):
    """A pickle whose class is ``torch_geometric.data.Data``, as a
    reference run writes it (main.py:190), made without that package."""
    data_cls = type("Data", (), {"__module__": "torch_geometric.data"})
    parent = types.ModuleType("torch_geometric")
    parent.data = types.ModuleType("torch_geometric.data")
    parent.data.Data = data_cls
    monkeypatch.setitem(sys.modules, "torch_geometric", parent)
    monkeypatch.setitem(sys.modules, "torch_geometric.data", parent.data)
    obj = data_cls()
    obj.__dict__.update(fields)
    torch.save(obj, path)


@pytest.mark.parametrize("layout", ["dict", "pyg_data", "pyg_store",
                                    "segno"])
def test_reference_pickle_loads_as_jax(tmp_path, monkeypatch, layout):
    rng = np.random.RandomState(1)
    t = torch.tensor(rng.randn(3, 4, 5, 3))
    fields = {"targets": t, "preds": t[:, :2] + 0.1,
              "energy_conservation": torch.ones(3, 2, 1), "test_loss": 0.5}
    if layout == "segno":           # train_nbody.py:191-195
        fields = {"targets": t, "preds": t[:, :2] + 0.1,
                  "energies": torch.ones(3, 2, 1), "loss": 6.0, "counter": 4}
    p = tmp_path / "x_results.pt"
    _forget(monkeypatch, TG + ("wandb",))
    if layout == "pyg_data":
        _save_as_torch_geometric_data(p, fields, monkeypatch)
        _forget(monkeypatch, TG)
    elif layout == "pyg_store":
        torch.save(_FakePyGData(fields), p)
    else:
        torch.save(fields, p)

    monkeypatch.setattr(sys, "path", list(sys.path))
    port = tresults.load_artifact(p)
    if layout == "pyg_data":
        assert sys.modules["torch_geometric.data"].Data is ref_stubs.Data
        _forget(monkeypatch, TG)
    jax_art = jresults.load_artifact(p)
    _assert_equal_trees(port, jax_art)
    assert port["targets"].shape == (3, 4, 5, 3)
    assert float(port["test_loss"]) == (1.5 if layout == "segno" else 0.5)


def test_ref_stub_install_is_idempotent_and_fills_bare_modules(monkeypatch):
    _forget(monkeypatch, TG)
    monkeypatch.setitem(sys.modules, "torch_geometric.data",
                        types.ModuleType("torch_geometric.data"))
    ref_stubs.install()
    ref_stubs.install()
    assert sys.modules["torch_geometric.data"].Data is ref_stubs.Data
    assert sys.modules["torch_geometric"].data is \
        sys.modules["torch_geometric.data"]
    d = ref_stubs.Data.from_dict({"a": 1})
    assert d.to_dict() == {"a": 1} and repr(d) == "Data(a)"


# ---------- profiling ----------

def test_phase_timer_matches_jax_on_one_clock(monkeypatch):
    import time

    def run(mod):
        ticks = iter(np.arange(0.0, 100.0, 0.37).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = mod.PhaseTimer()
        for name in ("load", "train", "train", "eval", "train"):
            with timer.phase(name, block_on=[np.zeros(2), {"a": (1, 2)}]):
                pass
        with pytest.raises(ValueError):
            with timer.phase("fails"):
                raise ValueError("inside a phase")
        return timer

    port, jax_timer = run(tprofiling), run(jprofiling)
    assert port.summary() == jax_timer.summary()
    assert port.report() == jax_timer.report()
    assert port.summary()["train"] == {"total_s": 1.11, "count": 3,
                                       "mean_s": 0.37}
    assert port.summary()["fails"]["count"] == 1


def test_phase_timer_reads_block_on_when_the_body_ends():
    timer = tprofiling.PhaseTimer()
    out = []
    with timer.phase("step", block_on=out):
        out.append((torch.ones(2), {"x": [torch.zeros(1)]}))
    assert timer.counts["step"] == 1
    assert tprofiling._cuda_devices(out, set()) == set()


def test_trace_writes_a_trace_file(tmp_path):
    with tprofiling.trace(tmp_path):
        with tprofiling.annotate("port_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "port_region" in files[0].read_text()
