"""The port's driver end to end against the JAX package: the EGNO test
rollout, training with validation, early stopping and the reload of the
best checkpoint, the ``--config_by_file`` presets, the port's device rule
and what main.py refuses.

A tiny charged dataset in the reference ``.npy`` layout (S=8, F=55, N=5,
loc/vel [S, F, 3, N]) is evaluated by nonode_tpu's EGNOExperiment.test_rollout
and by ``python -m nonode_tpu_torch.main --only_test true --device cpu`` on a
checkpoint converted from the same JAX weights. Tolerance 1e-4 (rtol and
atol): fp32 in another order, carried through two fed-back windows of the
4-layer canonical EGNO. The training run is held to the JAX driver on the
same data from the same weights: rtol 1e-4 on every loss it reports, fp32
in another order through two epochs of Adam-L2.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from nonode_tpu.analysis.registry import artifact_stem as jax_artifact_stem
from nonode_tpu.config import load_model_config as jax_load_config
from nonode_tpu import main as jmain
from nonode_tpu.data.nbody import NBodyDataset as JaxNBodyDataset
from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.train.loop import EGNOExperiment as JaxExperiment
from nonode_tpu_torch import main as tmain
from nonode_tpu_torch import runtime
from nonode_tpu_torch.analysis.registry import artifact_stem
from nonode_tpu_torch.compat.params import egno_state_dict_from_jax_params
from nonode_tpu_torch.config import EGNOConfig, load_model_config, overlay
from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.egno import EGNO
from nonode_tpu_torch.train.checkpoint import save_params
from nonode_tpu_torch.train.loop import EGNOExperiment
from torch_port_util import write_charged_split, write_gravity_split

TOL = dict(rtol=1e-4, atol=1e-4)
S, F, N = 8, 55, 5


def _write_charged_split(d, partition="test", seed=0):
    write_charged_split(d, partition, seed, s=S, f=F, n=N)


def test_only_test_main_matches_jax_test_rollout(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _write_charged_split(data)
    cfg = EGNOConfig()
    jm = JaxEGNO(n_layers=cfg.n_layers, hidden_nf=cfg.hidden_nf,
                 num_modes=cfg.num_modes, time_emb_dim=cfg.time_emb_dim)
    params = jm.init(jax.random.PRNGKey(0))
    jds = JaxNBodyDataset(data, partition="test", traj_len=2)
    jloss, jsteps, jart = JaxExperiment(jm).test_rollout(
        params, jds, 4, np.random.RandomState(42))

    outf = tmp_path / "out"
    stem = artifact_stem("egno", "charged", 42, N)
    model = EGNO(device="cpu")
    model.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), cfg.n_layers), strict=True)
    save_params(outf / "exp" / f"{stem}.ckpt", model)
    args = tmain.get_args([
        "--model", "egno", "--only_test", "true", "--device", "cpu",
        "--load_checkpoint", "true", "--data_dir", str(data),
        "--outf", str(outf), "--exp_name", "exp", "--batch_size", "4",
        "--traj_len", "2"])
    _, test_loss, _ = tmain.main(args)

    art = np.load(outf / "exp" / f"{stem}_results.npz")
    assert art["targets"].shape == (8, 20, N, 3)
    assert art["preds"].shape == (8, 8, N, 3)               # cut 0.4*2*10
    assert art["energy_conservation"].shape == (8, 8, 1)
    assert np.isfinite(art["preds"][:, :10]).all()          # first window
    assert test_loss == pytest.approx(jloss, rel=1e-4)
    assert float(art["test_loss"]) == pytest.approx(jloss, rel=1e-4)
    for key in ("targets", "preds", "energy_conservation"):
        np.testing.assert_allclose(art[key], jart[key], equal_nan=True, **TOL)
    for key in ("finite_fraction", "test_loss_finite"):
        assert float(art[key]) == pytest.approx(jart[key], rel=1e-4,
                                                nan_ok=True)
    results = json.loads((outf / "exp" / f"{stem}.json").read_text())
    assert results["test loss"] == [pytest.approx(jloss, rel=1e-4)]

    # avg_num_steps goes to the metrics log, as nonode_tpu.main writes it
    log = (outf / "exp" / f"{stem}_metrics.jsonl").read_text().splitlines()
    assert json.loads(log[-1])["avg_num_steps"] == pytest.approx(jsteps)


@pytest.mark.parametrize("varDT", [False, True])
def test_multi_input_test_rollout_matches_jax(tmp_path, varDT):
    """num_inputs=3: per-sample input offsets (random under varDT, drawn
    from the same numpy stream on both sides), the batch-global time
    correction and the multi-frame feedback."""
    _write_charged_split(tmp_path, seed=1)
    jm = JaxEGNO(n_layers=2, hidden_nf=16, time_emb_dim=8, num_inputs=3,
                 varDT=varDT)
    params = jm.init(jax.random.PRNGKey(1))
    kw = dict(partition="test", traj_len=2, num_inputs=3, varDT=varDT)
    jloss, jsteps, jart = JaxExperiment(jm).test_rollout(
        params, JaxNBodyDataset(tmp_path, **kw), 4, np.random.RandomState(3))
    model = EGNO(n_layers=2, hidden_nf=16, time_emb_dim=8, num_inputs=3,
                 varDT=varDT, device="cpu")
    model.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), 2), strict=True)
    loss, steps, art = EGNOExperiment(model).test_rollout(
        NBodyDataset(tmp_path, device="cpu", **kw), 4, np.random.RandomState(3))
    assert np.isfinite(art["preds"][:, :10]).all()
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert steps == pytest.approx(jsteps)
    for key in ("targets", "preds", "energy_conservation"):
        np.testing.assert_allclose(art[key], jart[key], equal_nan=True, **TOL)


def test_config_and_stem_match_jax(tmp_path):
    assert artifact_stem("egno", "charged", 3, 5, 2, 1, True, 10) == \
        jax_artifact_stem("egno", "charged", 3, 5, 2, 1, True, 10)
    ours = load_model_config("egno", "model_confs.yaml")
    ref = jax_load_config("egno", "model_confs.yaml")
    assert vars(ours) == vars(ref)
    assert load_model_config("egno") == ours      # defaults = model_confs.yaml
    (tmp_path / "c.yaml").write_text(
        "EGNO:\n  num_timesteps: 5\n  model_params: {hidden_nf: 16}\n")
    assert load_model_config("egno", tmp_path / "c.yaml").hidden_nf == 16


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(tmp_path, no_cuda):
    data = tmp_path / "data"
    data.mkdir()
    _write_charged_split(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EGNO(n_layers=1, hidden_nf=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NBodyDataset(data, partition="test")
    args = tmain.get_args(["--model", "egno", "--only_test", "true",
                           "--data_dir", str(data), "--outf", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(args)
    assert runtime.resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("extra,error", [
    (["--model", "segno"], NotImplementedError),
    (["--precision", "bf16"], NotImplementedError),
    (["--dp", "2"], NotImplementedError),
    (["--traj_len", "0"], ValueError),
], ids=["segno", "bf16", "dp", "traj_len0"])
def test_main_refuses_what_is_not_ported(extra, error):
    base = {"--model": "egno", "--only_test": "true", "--device": "cpu"}
    argv = []
    for k, v in base.items():
        if k not in extra:
            argv += [k, v]
    with pytest.raises(error, match="ROADMAP|traj_len"):
        tmain.main(tmain.get_args(argv + extra))


def _tiny_preset(path, data):
    """A JSON preset in the schema of configs/config_simulation_simple_no.json
    at a tiny width."""
    path.write_text(json.dumps({
        "exp_name": "tiny", "batch_size": 4, "epochs": 2, "seed": 42,
        "lr": 1e-3, "nf": 16, "model": "egno", "n_layers": 2,
        "max_training_samples": 8, "data_dir": str(data),
        "weight_decay": 1e-8, "time_emb_dim": 8, "num_modes": 2}))
    return path


def _training_main_matches_jax(tmp_path, dataset, write_split):
    data = tmp_path / "data"
    data.mkdir()
    for seed, part in enumerate(("train", "valid", "test")):
        write_split(data, part, seed=seed, s=S, f=F, n=N)
    preset = _tiny_preset(tmp_path / "tiny.json", data)
    common = ["--model", "egno", "--only_test", "false", "--test_interval",
              "1", "--traj_len", "2", "--config_by_file", str(preset),
              "--dataset", dataset]

    jargs = jmain.get_args(common + ["--outf", str(tmp_path / "jax")])
    jbest, jtest, jepoch = jmain.main(jargs)
    stem = jax_artifact_stem("egno", dataset, 42, N)
    jres = json.loads((tmp_path / "jax" / "tiny" / f"{stem}.json")
                      .read_text())

    # the port starts from the same weights: the JAX seed-42 init, saved
    # where --load_checkpoint looks
    jm = JaxEGNO(n_layers=2, hidden_nf=16, time_emb_dim=8)
    model = EGNO(n_layers=2, hidden_nf=16, time_emb_dim=8, device="cpu")
    model.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(42))), 2),
        strict=True)
    outf = tmp_path / "port"
    save_params(outf / "tiny" / f"{stem}.ckpt", model)
    targs = tmain.get_args(common + ["--outf", str(outf), "--device", "cpu",
                                     "--load_checkpoint", "true"])
    best, test_loss, epoch = tmain.main(targs)

    res = json.loads((outf / "tiny" / f"{stem}.json").read_text())
    assert set(res) == set(jres) == {"train loss", "val loss", "eval epoch",
                                     "test loss"}
    assert res["eval epoch"] == jres["eval epoch"] == [1]
    assert epoch == jepoch == 1
    for key in ("train loss", "val loss", "test loss"):
        assert len(res[key]) == len(jres[key])
        assert res[key] == pytest.approx(jres[key], rel=1e-4), key
    assert best == pytest.approx(jbest, rel=1e-4)
    assert test_loss == pytest.approx(jtest, rel=1e-4)

    # the checkpoint holds the trained weights, and the rollout used them
    trained = EGNO(n_layers=2, hidden_nf=16, time_emb_dim=8, device="cpu")
    trained.load_state_dict(torch.load(outf / "tiny" / f"{stem}.ckpt",
                                       weights_only=True))
    assert not torch.equal(trained.embedding.weight, model.embedding.weight)
    art = np.load(outf / "tiny" / f"{stem}_results.npz")
    jart = np.load(tmp_path / "jax" / "tiny" / f"{stem}_results.npz")
    assert set(art.files) == set(jart.files)
    for key in ("targets", "preds", "energy_conservation"):
        np.testing.assert_allclose(art[key], jart[key], equal_nan=True,
                                   rtol=1e-4, atol=1e-4)


def test_training_main_matches_jax_driver(tmp_path):
    """``--only_test false`` with a JSON preset: both drivers train two
    epochs from the JAX package's seed-42 weights, validate at epoch 1, save
    and reload the best checkpoint, and roll out the test split."""
    _training_main_matches_jax(tmp_path, "charged", write_charged_split)


def test_gravity_training_main_matches_jax_driver(tmp_path):
    """The same on gravity splits: windows from frame 0, masses as the pair
    weights, the gravity energy in the artifact."""
    _training_main_matches_jax(tmp_path, "gravity", write_gravity_split)


@pytest.mark.parametrize("partition", ["train", "val", "test"])
def test_gravity_split_loads_as_jax_does(tmp_path, partition):
    """data/nbody.py's gravity branch: frame_0 = 0, [S, F, N, 3] kept as it
    is, masses in place of charges (their products as pair weights), and
    the positive-mass check."""
    write_gravity_split(tmp_path, "valid" if partition == "val" else
                        partition, seed=4, s=6, f=30)
    kw = dict(partition=partition, dataset="gravity", traj_len=2,
              max_samples=5)
    jds, ds = JaxNBodyDataset(tmp_path, **kw), NBodyDataset(
        tmp_path, device="cpu", **kw)
    assert ds.start == jds.start == 0 and len(ds) == len(jds) == 5
    for name in ("loc", "vel", "charges", "edge_weights"):
        np.testing.assert_array_equal(getattr(ds, name).numpy(),
                                      np.asarray(getattr(jds, name)))
    np.testing.assert_array_equal(ds.out_indices(), jds.out_indices())
    suffix = f"{ds.suffix}.npy"
    masses = np.load(tmp_path / f"charges_{suffix}")
    np.save(tmp_path / f"charges_{suffix}", -masses)
    with pytest.raises(ValueError, match="should be positive"):
        NBodyDataset(tmp_path, device="cpu", **kw)
    with pytest.raises(AssertionError, match="should be positive"):
        JaxNBodyDataset(tmp_path, **kw)


def test_training_main_on_the_committed_split(tmp_path):
    """The port's training branch alone on the committed charged-5 splits,
    cut to 100 training samples, two epochs and two test windows: the
    results JSON, the best checkpoint and the artifact."""
    outf = tmp_path / "out"
    args = tmain.get_args([
        "--model", "egno", "--only_test", "false", "--device", "cpu",
        "--data_dir", "data", "--max_samples", "100", "--batch_size", "100",
        "--epochs", "2", "--test_interval", "1", "--traj_len", "2",
        "--outf", str(outf)])
    best, test_loss, epoch = tmain.main(args)
    stem = artifact_stem("egno", "charged", 42, N)
    res = json.loads((outf / args.exp_name / f"{stem}.json").read_text())
    assert len(res["train loss"]) == 2 and res["eval epoch"] == [1]
    assert np.isfinite(res["train loss"]).all()
    assert res["val loss"] == [best] and epoch == 1 and np.isfinite(best)
    assert res["test loss"] == [test_loss] and np.isfinite(test_loss)
    assert (outf / args.exp_name / f"{stem}.ckpt").is_file()
    art = np.load(outf / args.exp_name / f"{stem}_results.npz")
    assert art["targets"].shape == (2000, 20, N, 3)
    assert art["preds"].shape == (2000, 8, N, 3)


def test_config_by_file_matches_jax_driver():
    """The bare flag loads the port's copy of the preset; the namespace and
    the model config come out as nonode_tpu.main's."""
    argv = ["--model", "egno", "--config_by_file", "--scale_lr", "2"]
    ours, ref = tmain.get_args(argv), jmain.get_args(argv)
    assert ours._cfg_overrides == ref._cfg_overrides
    mine = {k: v for k, v in vars(ours).items() if k not in ("config",
                                                                  "device")}
    theirs = {k: v for k, v in vars(ref).items() if k != "config"}
    assert mine == theirs
    assert (ours.batch_size, ours.num_timesteps, ours.max_samples,
            ours.exp_name) == (100, 5, 3000, "simulation_exp")
    cfg = overlay(load_model_config("egno"), ours._cfg_overrides)
    jcfg = jax_load_config("egno", "model_confs.yaml")
    jcfg = dataclasses.replace(jcfg, **{
        k: (float(v) if k in ("lr", "weight_decay") else v)
        for k, v in ref._cfg_overrides.items()})
    assert vars(cfg) == vars(jcfg)
