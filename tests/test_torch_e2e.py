"""The port's driver end to end against the JAX package: the EGNO and SEGNO
test rollouts, training with validation, early stopping and the reload of
the best checkpoint, SEGNO's plain test epoch, the ``--config_by_file``
presets, the port's device rule and what main.py refuses.

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
from nonode_tpu.models.segno import SEGNO as JaxSEGNO
from nonode_tpu.train.loop import EGNOExperiment as JaxExperiment
from nonode_tpu.train.loop import SEGNOExperiment as JaxSEGNOExperiment
from nonode_tpu_torch import main as tmain
from nonode_tpu_torch import runtime
from nonode_tpu_torch.analysis.registry import artifact_stem
from nonode_tpu_torch.compat.params import (egno_state_dict_from_jax_params,
                                            segno_state_dict_from_jax_params)
from nonode_tpu_torch.config import (EGNOConfig, SEGNOConfig,
                                     load_model_config, overlay)
from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.egno import EGNO
from nonode_tpu_torch.models.segno import SEGNO
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
    (["--model", "segno", "--space", "2"], ValueError),
    (["--precision", "bf16", "--dp", "3"], ValueError),
    (["--batch_size", "256", "--dp", "3"], ValueError),
    (["--traj_len", "0"], ValueError),
], ids=["segno", "bf16", "dp", "traj_len0"])
def test_main_refuses_what_is_not_ported(extra, error):
    """What the JAX driver asserts before it builds its mesh
    (nonode_tpu/main.py:209-214: the batch over --dp, the particles over
    --space; SEGNO at the default 5 bodies, bf16 with a --dp that does not
    divide the default batch of 256) raises ValueError before any rank
    starts; so does EGNO at --traj_len 0."""
    base = {"--model": "egno", "--only_test": "true", "--device": "cpu"}
    argv = []
    for k, v in base.items():
        if k not in extra:
            argv += [k, v]
    with pytest.raises(error, match="not divisible|traj_len"):
        tmain.main(tmain.get_args(argv + extra))


def _tiny_preset(path, data, model="egno"):
    """A JSON preset in the schema of configs/config_simulation_simple_no.json
    at a tiny width (for SEGNO too: its EGNO-only keys time_emb_dim and
    num_modes are left out of the SEGNO config)."""
    path.write_text(json.dumps({
        "exp_name": "tiny", "batch_size": 4, "epochs": 2, "seed": 42,
        "lr": 1e-3, "nf": 16, "model": model, "n_layers": 2,
        "max_training_samples": 8, "data_dir": str(data),
        "weight_decay": 1e-8, "time_emb_dim": 8, "num_modes": 2}))
    return path


def _tiny_models(model, extra=()):
    """The preset's model in both packages, the port's holding the JAX
    package's seed-42 weights (JAX's driver initialises from that key)."""
    if model == "egno":
        extra = list(extra)
        L = int(extra[extra.index("--num_inputs") + 1]) \
            if "--num_inputs" in extra else 1
        kw = dict(n_layers=2, hidden_nf=16, time_emb_dim=8, num_inputs=L)
        jm = JaxEGNO(**kw)
        tm = EGNO(device="cpu", **kw)
        convert = lambda p: egno_state_dict_from_jax_params(p, 2)  # noqa: E731
    else:
        multi = "--num_inputs" in extra
        jm = JaxSEGNO(hidden_nf=16, n_layers=2,
                      multiple_agg="attn" if multi else None)
        tm = SEGNO(hidden_nf=16, multiple_agg="attn" if multi else None,
                   device="cpu")
        convert = segno_state_dict_from_jax_params
    tm.load_state_dict(convert(jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(42)))), strict=True)
    return tm


def _run_both_drivers(tmp_path, model, dataset, extra=(), f=F, n=N):
    """Both drivers on the same tiny preset and splits (S samples of ``f``
    frames, ``n`` bodies); the port starts from the JAX driver's weights,
    saved where --load_checkpoint looks. Returns the stem and each driver's
    (results JSON, main's return)."""
    data = tmp_path / "data"
    data.mkdir()
    write_split = write_charged_split if dataset == "charged" else \
        write_gravity_split
    for seed, part in enumerate(("train", "valid", "test")):
        write_split(data, part, seed=seed, s=S, f=f, n=n)
    preset = _tiny_preset(tmp_path / "tiny.json", data, model)
    common = ["--model", model, "--only_test", "false", "--test_interval",
              "1", "--traj_len", "2", "--config_by_file", str(preset),
              "--dataset", dataset, *extra]

    jargs = jmain.get_args(common + ["--outf", str(tmp_path / "jax")])
    jout = jmain.main(jargs)
    stem = jax_artifact_stem(model, dataset, 42, n, jargs.num_inputs,
                             jargs.dT, jargs.varDT)
    jres = json.loads((tmp_path / "jax" / "tiny" / f"{stem}.json")
                      .read_text())
    outf = tmp_path / "port"
    save_params(outf / "tiny" / f"{stem}.ckpt", _tiny_models(model, extra))
    targs = tmain.get_args(common + ["--outf", str(outf), "--device", "cpu",
                                     "--load_checkpoint", "true"])
    out = tmain.main(targs)
    res = json.loads((outf / "tiny" / f"{stem}.json").read_text())
    return stem, (jres, jout), (res, out)


def _training_main_matches_jax(tmp_path, dataset, model="egno", extra=(),
                               **split):
    stem, (jres, (jbest, jtest, jepoch)), (res, (best, test_loss, epoch)) = \
        _run_both_drivers(tmp_path, model, dataset, extra, **split)
    outf = tmp_path / "port"

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
    start = _tiny_models(model, extra)
    trained = torch.load(outf / "tiny" / f"{stem}.ckpt", weights_only=True)
    assert set(trained) == set(start.state_dict())
    assert not torch.equal(trained["embedding.weight"],
                           start.embedding.weight)
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
    _training_main_matches_jax(tmp_path, "charged")


def test_gravity_training_main_matches_jax_driver(tmp_path):
    """The same on gravity splits: windows from frame 0, masses as the pair
    weights, the gravity energy in the artifact."""
    _training_main_matches_jax(tmp_path, "gravity")


@pytest.mark.parametrize("dataset", ["charged", "gravity"])
def test_segno_training_main_matches_jax_driver(tmp_path, dataset):
    """``--model segno --only_test false`` with a JSON preset that also
    carries EGNO-only keys: both drivers train two epochs from the JAX
    package's seed-42 weights, validate, reload the best checkpoint and roll
    out the test split; every loss within rtol 1e-4."""
    _training_main_matches_jax(tmp_path, dataset, "segno")


@pytest.mark.parametrize("varDT", [False, True])
def test_segno_multi_input_training_main_matches_jax_driver(tmp_path, varDT):
    """Three inputs fused by attention; with --varDT the epochs draw their
    segment lengths per batch (the dynamic epochs) and the test rollout per
    batch."""
    _training_main_matches_jax(
        tmp_path, "charged", "segno",
        ["--num_inputs", "3", "--varDT", str(varDT).lower()])


@pytest.mark.parametrize("model,extra,split", [
    ("egno", ["--dT", "2"], dict(f=75)),
    ("egno", ["--dT", "2", "--num_inputs", "3", "--varDT", "true"],
     dict(f=75)),
    ("segno", ["--dT", "2", "--num_inputs", "3", "--varDT", "true"],
     dict(f=75)),
    ("egno", ["--n_balls", "10"], dict(n=10)),
    ("segno", ["--n_balls", "10"], dict(n=10))],
    ids=["egno-dT2", "egno-dT2-multi-varDT", "segno-dT2-multi-varDT",
         "egno-n10", "segno-n10"])
def test_drivers_match_jax_at_dT_and_n_balls(tmp_path, model, extra, split):
    """--dT 2 (EGNO's out frames every second frame, the stem's dT) and
    --n_balls 10 through both drivers, training, validating and rolling
    out as the other driver tests do (every loss within rtol 1e-4). The
    dT=2 splits have 75 frames, so that the test rollout's two windows of
    10 frames 2 apart fit after the charged start (frame 30) and no window
    is cut short in either driver."""
    _training_main_matches_jax(tmp_path, "charged", model, extra, **split)


def test_segno_traj_len_0_runs_the_plain_test_epoch(tmp_path):
    """At --traj_len 0 both drivers evaluate the test split with the plain
    epoch after training, report its loss and write no artifact."""
    stem, (jres, (_, jtest, _)), (res, (_, test_loss, _)) = \
        _run_both_drivers(tmp_path, "segno", "charged", ["--traj_len", "0"])
    assert res["test loss"] == pytest.approx(jres["test loss"], rel=1e-4)
    assert test_loss == pytest.approx(jtest, rel=1e-4)
    assert res["train loss"] == pytest.approx(jres["train loss"], rel=1e-4)
    for side in ("jax", "port"):
        assert not (tmp_path / side / "tiny" / f"{stem}_results.npz").exists()


def test_segno_only_test_main_matches_jax_test_rollout(tmp_path):
    """``--model segno --only_test true`` at the model_confs.yaml:SEGNO
    width on a checkpoint converted from JAX weights, against
    SEGNOExperiment.test_rollout. Tolerance 1e-4: two fed-back windows of
    10 weight-tied steps."""
    data = tmp_path / "data"
    data.mkdir()
    _write_charged_split(data)
    cfg = SEGNOConfig()
    jm = JaxSEGNO(hidden_nf=cfg.hidden_nf, n_layers=cfg.n_layers)
    params = jm.init(jax.random.PRNGKey(0))
    jds = JaxNBodyDataset(data, partition="test", traj_len=2)
    jloss, jsteps, jart = JaxSEGNOExperiment(jm).test_rollout(
        params, jds, 4, np.random.RandomState(42), 2, False)

    outf = tmp_path / "out"
    stem = artifact_stem("segno", "charged", 42, N)
    model = SEGNO(hidden_nf=cfg.hidden_nf, device="cpu")
    model.load_state_dict(segno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    save_params(outf / "exp" / f"{stem}.ckpt", model)
    args = tmain.get_args([
        "--model", "segno", "--only_test", "true", "--device", "cpu",
        "--load_checkpoint", "true", "--data_dir", str(data),
        "--outf", str(outf), "--exp_name", "exp", "--batch_size", "4",
        "--traj_len", "2"])
    _, test_loss, _ = tmain.main(args)

    art = np.load(outf / "exp" / f"{stem}_results.npz")
    assert art["targets"].shape == art["preds"].shape == (8, 2, N, 3)
    assert art["energy_conservation"].shape == (8, 2, 1)
    assert np.isfinite(art["preds"]).all()
    assert test_loss == pytest.approx(jloss, rel=1e-4)
    for key in ("targets", "preds", "energy_conservation"):
        np.testing.assert_allclose(art[key], jart[key], **TOL)
    log = (outf / "exp" / f"{stem}_metrics.jsonl").read_text().splitlines()
    assert json.loads(log[-1])["avg_num_steps"] == pytest.approx(jsteps)


def test_segno_config_and_preset_filter_match_jax(tmp_path):
    """load_model_config("segno") reads the SEGNO section as nonode_tpu's
    does; a preset's EGNO-only keys (time_emb_dim, num_modes) are dropped
    from a SEGNO config, as nonode_tpu/main.py:126-134 drops them, and kept
    for EGNO."""
    ours = load_model_config("segno", "model_confs.yaml")
    assert vars(ours) == vars(jax_load_config("segno", "model_confs.yaml"))
    assert load_model_config("segno") == ours == SEGNOConfig()
    preset = _tiny_preset(tmp_path / "p.json", tmp_path, "segno")
    args = tmain.get_args(["--model", "segno", "--config_by_file",
                           str(preset)])
    assert {"time_emb_dim", "num_modes"} <= set(args._cfg_overrides)
    cfg = overlay(ours, args._cfg_overrides)
    fields = {f.name for f in dataclasses.fields(SEGNOConfig)}
    jcfg = dataclasses.replace(jax_load_config("segno", "model_confs.yaml"),
                               **{k: v for k, v in args._cfg_overrides.items()
                                  if k in fields})
    assert vars(cfg) == vars(jcfg)
    assert (cfg.hidden_nf, cfg.n_layers, cfg.lr) == (16, 2, 1e-3)
    egno = overlay(load_model_config("egno"), args._cfg_overrides)
    assert (egno.time_emb_dim, egno.hidden_nf) == (8, 16)


def test_segno_entry_points_raise_without_cuda(tmp_path, no_cuda):
    data = tmp_path / "data"
    data.mkdir()
    _write_charged_split(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SEGNO(hidden_nf=16)
    args = tmain.get_args(["--model", "segno", "--only_test", "true",
                           "--data_dir", str(data), "--outf", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(args)


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
