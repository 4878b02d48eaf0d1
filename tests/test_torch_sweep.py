"""The port's sweep (nonode_tpu_torch/parallel/sweep.py) against the JAX
package's (nonode_tpu/parallel/sweep.py).

- The grid helpers (load_schedule, expand_grid, config_id, group_for_fleet,
  summarize) on both built-in grids and on every scripts/*schedule*.yaml
  grid, read through both packages' load_schedule; the same grids written
  as JSON expand to the same list.
- The sequential sweep through both packages on a 4-config grid (EGNO and
  SEGNO, two seeds) at a tiny width, the port starting each config from the
  JAX driver's weights for that seed: the same config_ids in the same
  order and the same ledger keys, test_loss and best_val_loss within rtol
  1e-4 (fp32 in another order through two epochs of Adam-L2, as
  tests/test_torch_e2e.py holds the drivers), best_epoch equal; a second
  call runs nothing, appends nothing and returns the same rows.
- The fleet branch: its rows equal the records of the port's fleet_main on
  the same argv, in grid order, with ``"fleet": true``; JAX's fleet branch
  makes the same rows (keys and values) from the same records and passes
  the same argv, less ``--device``.
- Without CUDA the sweep raises unless ``--device cpu`` is given, and so
  does every driver run it starts.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from nonode_tpu import fleet_main as jfleet_main
from nonode_tpu.config import load_model_config as jax_load_config
from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.models.segno import SEGNO as JaxSEGNO
from nonode_tpu.parallel import sweep as jsweep
from nonode_tpu_torch import fleet_main as tfleet_main
from nonode_tpu_torch import main as tmain
from nonode_tpu_torch.analysis.registry import artifact_stem
from nonode_tpu_torch.compat.params import (egno_state_dict_from_jax_params,
                                            segno_state_dict_from_jax_params)
from nonode_tpu_torch.parallel import sweep as tsweep
from nonode_tpu_torch.runtime import seed_everything
from nonode_tpu_torch.train.checkpoint import save_params
from torch_port_util import write_charged_split

REPO = Path(__file__).resolve().parents[1]
SCHEDULES = sorted((REPO / "scripts").glob("*schedule*.yaml"))
GRIDS = [(None, "BASE"), (None, "PRO")] + [
    (path, grid) for path in SCHEDULES
    for grid in yaml.safe_load(path.read_text())]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: its tensors are tiny, and in a
    parallel test run a thread pool in every worker oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(**params):
    return {"method": "grid",
            "metric": {"goal": "minimize", "name": "test_loss"},
            "parameters": {k: ({"values": v} if isinstance(v, list)
                               else {"value": v}) for k, v in params.items()}}


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    """Charged-5 splits of 8 samples x 55 frames (test_torch_e2e.py's)."""
    d = tmp_path_factory.mktemp("sweep_data")
    for seed, part in enumerate(("train", "valid", "test")):
        write_charged_split(d, part, seed=seed, s=8, f=55)
    return d


@pytest.fixture(scope="module")
def tiny_conf(tmp_path_factory):
    """A model_confs.yaml-schema file at test_torch_e2e.py's tiny width,
    read by both drivers (--config)."""
    p = tmp_path_factory.mktemp("sweep_conf") / "tiny.yaml"
    p.write_text("EGNO:\n  model_params: {n_layers: 2, hidden_nf: 16, "
                 "time_emb_dim: 8}\nSEGNO:\n  model_params: {hidden_nf: 16}\n")
    return p


# ---------- grid helpers ----------

@pytest.mark.parametrize("path,grid", GRIDS, ids=[
    f"{p.stem if p else 'default'}-{g}" for p, g in GRIDS])
def test_grid_helpers_match_jax(tmp_path, path, grid):
    spec = tsweep.load_schedule(path and str(path), grid)
    assert spec == jsweep.load_schedule(path and str(path), grid)
    configs = tsweep.expand_grid(spec)
    assert configs == jsweep.expand_grid(spec)
    ids = [tsweep.config_id(c) for c in configs]
    assert ids == [jsweep.config_id(c) for c in configs]
    assert len(set(ids)) == len(ids)
    assert tsweep.group_for_fleet(configs) == jsweep.group_for_fleet(configs)

    # the same grid as JSON, the card's form: the port reads it with json,
    # JAX with yaml.safe_load (JSON is YAML)
    as_json = tmp_path / "grid.json"
    as_json.write_text(json.dumps({grid: spec}))
    for load in (tsweep.load_schedule, jsweep.load_schedule):
        assert tsweep.expand_grid(load(str(as_json), grid)) == configs

    rng = np.random.RandomState(len(configs))
    results = [{"config": c, "test_loss": float(v)}
               for c, v in zip(configs, rng.rand(len(configs)))]
    assert tsweep.summarize(results) == jsweep.summarize(results)


def test_missing_schedule_falls_back_to_the_built_in_grid(tmp_path):
    """JAX's semantics, kept: a path that does not exist reads the built-in
    grid of that name."""
    spec = tsweep.load_schedule(str(tmp_path / "absent.json"), "PRO")
    assert spec == tsweep.DEFAULT_SCHEDULE["PRO"]
    assert len(tsweep.expand_grid(spec)) == 96


# ---------- the sequential sweep through both packages ----------

def _jax_model(model, conf):
    """The model JAX's driver builds for one input at the config's width."""
    cfg = jax_load_config(model, conf)
    if model == "egno":
        return JaxEGNO(n_layers=cfg.n_layers, in_node_nf=cfg.in_node_nf,
                       in_edge_nf=cfg.in_edge_nf, hidden_nf=cfg.hidden_nf,
                       num_modes=cfg.num_modes,
                       num_timesteps=cfg.num_timesteps,
                       time_emb_dim=cfg.time_emb_dim, num_inputs=1,
                       varDT=False, with_v=cfg.with_v, flat=cfg.flat,
                       norm=cfg.norm), cfg
    return JaxSEGNO(in_node_nf=cfg.in_node_nf, in_edge_nf=cfg.in_edge_nf,
                    hidden_nf=cfg.hidden_nf, n_layers=cfg.n_layers,
                    recurrent=cfg.recurrent, tanh=cfg.tanh, varDT=False,
                    multiple_agg=None), cfg


def _cross_jax_weights(cfg, conf, outf):
    """Save the JAX driver's weights for ``cfg``'s seed (its
    PRNGKey(seed) init) as the port's checkpoint where --load_checkpoint
    looks, as tests/test_torch_e2e.py:_tiny_models crosses them."""
    model = cfg["model"]
    jm, jcfg = _jax_model(model, conf)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(cfg["seed"])))
    sd = (egno_state_dict_from_jax_params(params, jcfg.n_layers)
          if model == "egno" else segno_state_dict_from_jax_params(params))
    args = tmain.get_args(["--model", model, "--config", str(conf),
                           "--seed", str(cfg["seed"])])
    port = tmain.build_experiment(args, torch.device("cpu"),
                                  seed_everything(cfg["seed"])).model
    port.load_state_dict(sd, strict=True)
    stem = artifact_stem(model, cfg["dataset"], cfg["seed"], cfg["n_balls"])
    save_params(outf / cfg["exp_name"] / f"{stem}.ckpt", port)


def _ledger(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_sequential_sweep_matches_jax(tmp_path, tiny_data, tiny_conf,
                                      monkeypatch):
    sched = tmp_path / "grid.json"
    sched.write_text(json.dumps({"TINY": _grid(
        exp_name="_exp_new", dataset="charged", n_balls=5, num_inputs=1,
        varDT=False, model=["egno", "segno"], seed=[1, 2])}))
    common = {"data_dir": str(tiny_data), "epochs": 2, "batch_size": 4,
              "traj_len": 2, "test_interval": 1, "config": str(tiny_conf)}
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jres = jsweep.run_sweep("TINY", str(sched), {**common, "outf": str(jout)},
                            jout / "sweep_TINY.jsonl")
    configs = tsweep.expand_grid(tsweep.load_schedule(str(sched), "TINY"))
    for cfg in configs:
        _cross_jax_weights(cfg, tiny_conf, tout)
    over = {**common, "outf": str(tout), "device": "cpu",
            "load_checkpoint": True}
    ledger = tout / "sweep_TINY.jsonl"
    tres = tsweep.run_sweep("TINY", str(sched), over, ledger)

    jled, tled = _ledger(jout / "sweep_TINY.jsonl"), _ledger(ledger)
    ids = [tsweep.config_id(c) for c in configs]
    assert [r["config_id"] for r in tled] == [r["config_id"] for r in jled] \
        == [r["config_id"] for r in tres] == ids
    for t, j in zip(tled, jled):
        assert set(t) == set(j) == {"config_id", "config", "test_loss",
                                    "best_val_loss", "best_epoch", "wall_s"}
        assert t["config"] == j["config"]
        assert t["best_epoch"] == j["best_epoch"] == 1
        for key in ("test_loss", "best_val_loss"):
            assert np.isfinite(t[key])
            assert t[key] == pytest.approx(j[key], rel=1e-4), \
                (t["config_id"], key)
    assert [r["test_loss"] for r in jres] == [r["test_loss"] for r in jled]

    # resume: every config is in the ledger, so nothing runs again (a rerun
    # would evaluate the checkpoint the first run left at its save path)
    def no_run(args):
        raise AssertionError(f"a resumed sweep ran {args}")
    monkeypatch.setattr(tmain, "main", no_run)
    again = tsweep.run_sweep("TINY", str(sched), over, ledger)
    assert json.dumps(again) == json.dumps(tres)
    assert _ledger(ledger) == tled


# ---------- the fleet branch ----------

def test_fleet_branch_rows_are_fleet_main_records(tmp_path, tiny_data,
                                                 monkeypatch):
    """Two fleet groups (EGNO and SEGNO, seeds 1 and 2, the grid ordered
    seed-first so that the groups interleave in it)."""
    sched = tmp_path / "grid.json"
    sched.write_text(json.dumps({"FLEET": _grid(
        exp_name="_exp_new", seed=[1, 2], dataset="charged", n_balls=5,
        num_inputs=1, varDT=False, model=["egno", "segno"])}))
    outf = tmp_path / "port"
    over = {"data_dir": str(tiny_data), "outf": str(outf), "epochs": 2,
            "batch_size": 4, "traj_len": 2, "device": "cpu"}
    calls = []
    port_fleet = tfleet_main.main

    def spy(args):
        records = port_fleet(args)
        calls.append((vars(args).copy(), records))
        return records
    monkeypatch.setattr(tfleet_main, "main", spy)
    argv_seen = []
    port_get_args = tfleet_main.get_args
    monkeypatch.setattr(tfleet_main, "get_args",
                        lambda argv: argv_seen.append(argv)
                        or port_get_args(argv))
    ledger = outf / "sweep_FLEET.jsonl"
    rows = tsweep.run_sweep("FLEET", str(sched), over, ledger, use_fleet=True)

    configs = tsweep.expand_grid(tsweep.load_schedule(str(sched), "FLEET"))
    assert [r["config_id"] for r in rows] == \
        [tsweep.config_id(c) for c in configs]
    assert len(calls) == 2 and all("--device" in a for a in argv_seen)
    by_model = {a["model"]: recs for a, recs in calls}
    for row in rows:
        rec = by_model[row["config"]["model"]][[1, 2].index(
            row["config"]["seed"])]
        assert row["fleet"] is True and rec["seed"] == row["config"]["seed"]
        for key in ("test_loss", "best_val_loss", "best_epoch",
                    "test_loss_finite", "finite_fraction"):
            np.testing.assert_array_equal(row[key], rec[key])

    # the port's fleet_main alone on the same argv gives the same records
    for argv in argv_seen:
        alone = port_fleet(port_get_args(argv))
        model = argv[argv.index("--model") + 1]
        assert json.dumps(alone) == json.dumps(by_model[model])

    # JAX's fleet branch: the same argv less --device, and the same rows
    # (keys and values) from the same records
    jax_argv = []

    def jax_fleet(args):
        jax_argv.append(args)
        return by_model[args.model]
    monkeypatch.setattr(jfleet_main, "main", jax_fleet)
    jrows = jsweep.run_sweep("FLEET", str(sched), over,
                             tmp_path / "jax" / "sweep_FLEET.jsonl",
                             use_fleet=True)
    strip = lambda argv: argv[:argv.index("--device")] + \
        argv[argv.index("--device") + 2:]                   # noqa: E731
    assert [vars(a) for a in jax_argv] == \
        [vars(jfleet_main.get_args(strip(a))) for a in argv_seen]
    for t, j in zip(rows, jrows):
        assert set(t) == set(j)
        t, j = dict(t), dict(j)
        t.pop("wall_s"), j.pop("wall_s")
        assert json.dumps(t) == json.dumps(j)

    # resume: nothing runs, nothing is appended
    monkeypatch.setattr(tfleet_main, "main", lambda args: pytest.fail(
        f"a resumed sweep ran a fleet {args}"))
    lines = ledger.read_text()
    again = tsweep.run_sweep("FLEET", str(sched), over, ledger,
                             use_fleet=True)
    assert ledger.read_text() == lines
    assert json.dumps(again) == json.dumps(rows)


# ---------- the device rule ----------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("use_fleet", [False, True], ids=["driver", "fleet"])
def test_sweep_raises_without_cuda_unless_cpu_is_asked(tmp_path, tiny_data,
                                                       no_cuda, capsys,
                                                       use_fleet):
    sched = tmp_path / "grid.json"
    sched.write_text(json.dumps({"G": _grid(
        exp_name="_exp_new", dataset="charged", n_balls=5, num_inputs=1,
        varDT=False, model="segno", seed=[1, 2])}))
    argv = ["--schedule", str(sched), "--grid", "G", "--data_dir",
            str(tiny_data), "--outf", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsweep.main(argv)
    assert not (tmp_path / "out").exists()
    # a dry run on the CPU lists the configs and runs nothing
    tsweep.main(argv + ["--device", "cpu", "--dry_run"])
    assert capsys.readouterr().out.count("DRY ") == 2
    # the library entry: every driver run it starts takes cuda unless the
    # overrides say cpu, and raises here
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsweep.run_sweep("G", str(sched), {"data_dir": str(tiny_data),
                                           "outf": str(tmp_path / "lib")},
                         tmp_path / "lib" / "sweep_G.jsonl",
                         use_fleet=use_fleet)
    assert not (tmp_path / "lib" / "sweep_G.jsonl").exists()
