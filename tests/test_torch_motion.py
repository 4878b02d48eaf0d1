"""The port's mocap slice against the JAX package: the ASF/AMC parser and
forward kinematics, the datasets, edge matrices and split, the pairwise
chain at mocap's width (H=128, E=1, N=31 on the skeleton + 2-hop mask),
mocap's EGNO, and both ``motion_main`` drivers end to end.

The CMU trials are not in the repository: the datasets and drivers run on a
run case that chip_smoke.py writes (CMU's 31-bone skeleton, 11 trials of
140 frames, parsed by the port's data/amc.py into ``motion_run.pkl``).

Tolerances: the parser, the datasets and the split are the same numpy
arithmetic on both sides, so they are held bitwise (atol 0). The chain's
plain version against the Pallas op in interpret mode, and its VJP: 1e-5
(rtol and atol), fp32 sums of up to 128 products in another order. mocap's
EGNO: 5e-5 through two layers and the spectral convs. The drivers: rtol
1e-4 on every loss, fp32 in another order through Adam steps.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nonode_tpu import motion_main as jax_motion_main
from nonode_tpu.data import amc as jax_amc
from nonode_tpu.data import motion as jax_motion
from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.ops.pallas.egnn_fused import pairwise_message as jax_pairwise
from nonode_tpu_torch import motion_main
from nonode_tpu_torch.analysis.registry import FNAME_RE
from nonode_tpu_torch.compat.params import egno_state_dict_from_jax_params
from nonode_tpu_torch.data import amc, motion
from nonode_tpu_torch.models.egno import EGNO, effective_num_modes
from nonode_tpu_torch.ops.kernels import egnn_fused
from test_motion import AMC, ASF
from torch_port_util import assert_close, t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def run_case(tmp_path_factory):
    """A written run case: the ASF/AMC files and motion_run.pkl, no split."""
    d = tmp_path_factory.mktemp("mocap")
    chip_smoke.write_mocap_case(d)
    return d


def _copy_case(src, dst):
    dst.mkdir(exist_ok=True)
    (dst / "motion_run.pkl").write_bytes((src / "motion_run.pkl")
                                         .read_bytes())
    return dst


# ---- the parser ----

@pytest.mark.parametrize("fixture", ["test_motion", "cmu31"])
def test_amc_parse_and_fk_give_jax_bits(tmp_path, run_case, fixture):
    if fixture == "test_motion":
        asf, amcs = tmp_path / "test.asf", [tmp_path / "walk_09.amc",
                                            tmp_path / "walk_10.amc"]
        asf.write_text(ASF)
        for a in amcs:
            a.write_text(AMC)
    else:
        asf = run_case / "amc" / "09.asf"
        amcs = sorted((run_case / "amc").glob("*.amc"))
    joints, jjoints = amc.parse_asf(asf), jax_amc.parse_asf(asf)
    assert list(joints) == list(jjoints)
    for name, bone in joints.items():
        jb = jjoints[name]
        assert (bone.name, bone.length, bone.dof) == \
            (jb.name, jb.length, jb.dof)
        for a, b in ((bone.direction, jb.direction),
                     (bone.axis_deg, jb.axis_deg), (bone.limits, jb.limits)):
            np.testing.assert_array_equal(a, b)
        assert (bone.parent and bone.parent.name) == \
            (jb.parent and jb.parent.name)
    assert amc.parse_amc(amcs[0]) == jax_amc.parse_amc(amcs[0])
    edges, trials = amc.trajectories_from_amc(asf, amcs)
    jedges, jtrials = jax_amc.trajectories_from_amc(asf, amcs)
    assert edges == jedges
    assert [x.shape for x in trials] == [x.shape for x in jtrials]
    for x, jx in zip(trials, jtrials):
        np.testing.assert_array_equal(x, jx)
    # a trial whose stem ends in _10 loses its first 6 frames
    assert trials[-1 if fixture == "test_motion" else 9].shape[0] == \
        max(trials[0].shape[0] - 6, 0)


# ---- datasets, edge matrices, split ----

def test_edge_matrices_match_jax(run_case):
    with open(run_case / "motion_run.pkl", "rb") as f:
        edges, _ = pickle.load(f)
    for a, b in zip(motion.build_edge_matrices(edges, 31),
                    jax_motion.build_edge_matrices(edges, 31)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("partition", ["train", "val", "test"])
def test_datasets_match_jax(tmp_path, run_case, partition):
    d = _copy_case(run_case, tmp_path / "d")
    kw = dict(data_dir=d, partition=partition, max_samples=200,
              delta_frame=30, case="run")
    for cls, jcls, extra in (
            (motion.MotionDataset, jax_motion.MotionDataset, {}),
            (motion.MotionDynamicsDataset, jax_motion.MotionDynamicsDataset,
             {"num_timesteps": 5})):
        ds, jds = cls(**kw, **extra, device="cpu"), jcls(**kw, **extra)
        assert len(ds) == len(jds) and ds.n_node == jds.n_node == 31
        for name in ("x_0", "v_0", "x_t", "v_t", "edge_attr", "edge_mask"):
            got = getattr(ds, name)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jds, name)))
        x0 = ds.x_0[:3]
        assert_close(ds.node_features(x0), jds.node_features(jds.x_0[:3]),
                     rtol=0, atol=0)
    assert tuple(ds.x_t.shape[1:]) == (5, 31, 3)
    assert tuple(ds.edge_attr.shape) == (31, 31, 1)


def _same_split(a, b):
    assert len(a) == len(b) == 3
    for pa, pb in zip(a, b):
        assert list(pa) == list(pb)
        for k in pa:
            np.testing.assert_array_equal(np.asarray(pa[k]),
                                          np.asarray(pb[k]))


def test_split_is_jaxs_and_leaves_the_global_state(tmp_path, run_case):
    """The port draws JAX's split from a local RandomState(100), writes it
    where JAX would, and reads JAX's file; JAX reads the port's."""
    jdir = _copy_case(run_case, tmp_path / "jax")
    pdir = _copy_case(run_case, tmp_path / "port")
    np.random.seed(7)
    state = np.random.get_state()
    ours = motion._load_split(pdir, "run")
    after = np.random.get_state()
    assert after[0] == state[0] and after[2:] == state[2:]
    np.testing.assert_array_equal(after[1], state[1])
    jsplit = jax_motion._load_split(jdir, "run")       # seeds the global state
    np.random.set_state(state)
    _same_split(ours, jsplit)
    assert (pdir / "split_run.pkl").is_file()
    _same_split(motion._load_split(jdir, "run"), jsplit)   # JAX's file
    _same_split(jax_motion._load_split(pdir, "run"), ours)  # the port's file


def test_split_stays_in_memory_when_it_cannot_be_written(
        tmp_path, run_case, monkeypatch):
    d = _copy_case(run_case, tmp_path / "ro")

    def read_only(path, mode="r", *a, **kw):
        if "w" in mode:
            raise PermissionError(f"read-only: {path}")
        return open(path, mode, *a, **kw)

    monkeypatch.setattr(motion, "open", read_only, raising=False)
    split = motion._load_split(d, "run")
    assert not (d / "split_run.pkl").exists()
    _same_split(split, jax_motion._load_split(
        _copy_case(run_case, tmp_path / "j"), "run"))


# ---- the chain at mocap's width ----

def _mocap_chain_inputs(g, seed, coord_scale=1.0):
    rng = np.random.RandomState(seed)
    h, n = 128, 31
    f32 = lambda a: np.asarray(a, np.float32)                   # noqa: E731
    b = 1.0 / np.sqrt(h)
    x = f32(10.0 * rng.randn(g, n, 3))
    hi, hj = f32(0.5 * rng.randn(g, n, h)), f32(0.5 * rng.randn(g, n, h))
    efea = f32(rng.choice([0.0, 1.0, 2.0], (g, n, n, 1)))
    weights = (f32(0.01 * rng.randn(1, h)), f32(0.3 * rng.randn(1, h)),
               f32(0.1 * rng.randn(1, h)), f32(b * rng.randn(h, h)),
               f32(0.1 * rng.randn(1, h)), f32(b * rng.randn(h, h)),
               f32(0.1 * rng.randn(1, h)),
               f32(coord_scale * b * rng.randn(h, 1)),
               f32(0.1 * rng.randn(1, 1)))
    mask = chip_smoke.mocap_mask("cpu").numpy()
    return x, hi, hj, efea, mask, weights


@pytest.mark.parametrize("clip_edges", [False, True])
def test_plain_chain_at_h128_matches_pallas_and_its_vjp(clip_edges):
    """pairwise_message_reference and its backward at H=128, E=1, N=31 on
    the skeleton mask against the Pallas op (interpret mode) and its VJP."""
    x, hi, hj, efea, mask, weights = _mocap_chain_inputs(
        2, seed=5, coord_scale=40.0 if clip_edges else 1.0)
    rng = np.random.RandomState(6)
    gf = rng.randn(2, 31, 3).astype(np.float32)
    gm = rng.randn(2, 31, 128).astype(np.float32)
    jw = tuple(map(jnp.asarray, weights))

    def f(x, hi, hj, efea, jw):
        return jax_pairwise(clip_edges, x, hi, hj, efea, jnp.asarray(mask), jw)

    (jf, jm), vjp = jax.vjp(f, *map(jnp.asarray, (x, hi, hj, efea)), jw)
    jgrads = vjp((jnp.asarray(gf), jnp.asarray(gm)))
    args = (*map(t, (x, hi, hj, efea, mask)), tuple(map(t, weights)))
    tf, tm = egnn_fused.pairwise_message_reference(clip_edges, *args)
    assert_close(tf, jf, **TOL)
    assert_close(tm, jm, **TOL)
    if clip_edges:
        free, _ = egnn_fused.pairwise_message_reference(False, *args)
        assert float((free - tf).abs().max()) > 1.0, "the clip never engaged"
    dx, dhi, dhj, defea, dw = egnn_fused.pairwise_message_bwd_reference(
        clip_edges, *args, t(gf), t(gm))
    for got, want in zip((dx, dhi, dhj, defea, *dw),
                         (*jgrads[:4], *jgrads[4])):
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        assert_close(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale)


# ---- mocap's EGNO ----

def _mocap_models(n_layers, nf=128, t_steps=5, seed=0):
    kw = dict(n_layers=n_layers, in_node_nf=1, in_edge_nf=1, hidden_nf=nf,
              num_modes=2, num_timesteps=t_steps, time_emb_dim=32)
    jm = JaxEGNO(**kw)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = EGNO(device="cpu", **kw)
    tm.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), n_layers), strict=True)
    return jm, params, tm


def test_compat_carries_mocaps_egno_across():
    """configs/config_mocap_no.json's EGNO (one node and one edge feature,
    H=128, 6 layers, T=5: the clamp rule's 2 modes) crosses strictly."""
    jm, params, tm = _mocap_models(6)
    assert effective_num_modes(5, 2) == 2
    sd = tm.state_dict()
    for i in range(6):
        assert tuple(sd[f"time_conv_modules.{i}.t_conv.weights1"].shape) == \
            tuple(np.shape(params["time_conv"][i]["t_conv"]["w"]))
    w1 = sd["layers.0.edge_message_net.scalar_net.mlp.0.weight"]
    assert tuple(w1.shape) == (128, 1 + 2 * 128 + 1)
    assert tuple(sd["embedding.weight"].shape) == (128, 1 + 32)
    np.testing.assert_array_equal(
        w1.numpy(), np.asarray(params["layers"][0]["edge_net"]["l1"]["w"]))


def test_mocap_egno_matches_jax(run_case, tmp_path):
    """Two layers of mocap's EGNO at H=128 on a batch of the written case,
    the skeleton mask through the fused chain, from JAX's weights."""
    jm, params, tm = _mocap_models(2)
    ds = motion.MotionDynamicsDataset(
        data_dir=_copy_case(run_case, tmp_path / "d"), partition="train",
        max_samples=200, delta_frame=30, case="run", num_timesteps=5,
        device="cpu")
    exp = motion_main.MotionExperiment(tm, lr=5e-4, weight_decay=1e-10)
    batch = exp.batch(ds, None, 0, torch.arange(3))
    with torch.no_grad():
        got = exp.decode(batch)                            # [B, T, N, 3]
    x0 = jnp.asarray(batch[0].numpy())
    jx, _, _ = jm(params, x0, jnp.asarray(batch[1].numpy()),
                  jnp.asarray(batch[2].numpy()),
                  jnp.broadcast_to(jnp.asarray(ds.edge_attr.numpy()),
                                   (3, 31, 31, 1)),
                  x0.mean(axis=1, keepdims=True).repeat(31, 1),
                  edge_mask=jnp.asarray(ds.edge_mask.numpy()))
    scale = float(jnp.abs(jx).max())
    assert_close(got, jnp.swapaxes(jx, 0, 1), rtol=5e-5, atol=5e-5 * scale)


# ---- the drivers ----

def test_motion_main_matches_jax_driver(tmp_path, run_case, monkeypatch):
    """Both motion_mains at a tiny width on the written case, the port from
    JAX's seed-3 weights: every loss within rtol 1e-4, the artifact's
    shapes, its test_loss the MSE of its own preds, its name parsed by the
    port's FNAME_RE."""
    common = ["--epochs", "3", "--test_interval", "2", "--batch_size", "24",
              "--max_training_samples", "48", "--n_layers", "1", "--nf",
              "16", "--num_timesteps", "4", "--seed", "3"]
    jdir = _copy_case(run_case, tmp_path / "jdata")
    jbest, jtest = jax_motion_main.main(jax_motion_main.get_args(
        common + ["--data_dir", str(jdir), "--outf", str(tmp_path / "jax")]))

    build = motion_main.build_experiment

    def from_jax_weights(args, device, generator):
        exp = build(args, device, generator)
        kw = dict(n_layers=args.n_layers, in_node_nf=1, in_edge_nf=1,
                  hidden_nf=args.nf, num_modes=args.num_modes,
                  num_timesteps=args.num_timesteps,
                  time_emb_dim=args.time_emb_dim)
        params = JaxEGNO(**kw).init(jax.random.PRNGKey(args.seed))
        exp.model.load_state_dict(egno_state_dict_from_jax_params(
            jax.tree.map(np.asarray, params), args.n_layers), strict=True)
        return exp

    monkeypatch.setattr(motion_main, "build_experiment", from_jax_weights)
    pdir = _copy_case(run_case, tmp_path / "pdata")
    best, test = motion_main.main(motion_main.get_args(
        common + ["--data_dir", str(pdir), "--outf", str(tmp_path / "port"),
                  "--device", "cpu"]))
    assert best == pytest.approx(jbest, rel=1e-4)
    assert test == pytest.approx(jtest, rel=1e-4)
    name = "mocap_exp/EGNO_motion_run_seed=3.json"
    res = json.loads((tmp_path / "port" / name).read_text())
    jres = json.loads((tmp_path / "jax" / name).read_text())
    assert res["eval epoch"] == jres["eval epoch"] == [2]
    for key in ("train loss", "val loss", "test loss"):
        assert len(res[key]) == len(jres[key]) > 0
        assert res[key] == pytest.approx(jres[key], rel=1e-4), key
    arts = list((tmp_path / "port" / "mocap_exp").glob("*_results.npz"))
    assert len(arts) == 1
    m = FNAME_RE.match(arts[0].name)
    assert m and m["dataset"] == "motion_run" and m["seed"] == "3" \
        and m["n_balls"] == "31" and m["num_timesteps"] == "4"
    art = np.load(arts[0])
    jart = np.load(tmp_path / "jax" / "mocap_exp" / arts[0].name)
    assert art["preds"].shape == jart["preds"].shape == (240, 4, 31, 3)
    np.testing.assert_array_equal(art["targets"], jart["targets"])
    np.testing.assert_allclose(art["preds"], jart["preds"], rtol=1e-4,
                               atol=1e-4 * float(np.abs(jart["preds"]).max()))
    mse = float(((art["preds"] - art["targets"]) ** 2).mean())
    np.testing.assert_allclose(mse, float(art["test_loss"]), rtol=1e-5)


def test_motion_main_config_by_file_and_device_rule(tmp_path, monkeypatch):
    """The bare --config_by_file loads the port's copy of the JAX preset,
    read with json as JAX reads it; without CUDA the default device
    raises."""
    args = motion_main.get_args(["--config_by_file"])
    jargs = jax_motion_main.get_args(["--config_by_file"])
    assert vars(args) == {**vars(jargs), "device": "cuda"}
    assert (args.nf, args.n_layers, args.num_timesteps, args.batch_size,
            args.lr, args.weight_decay, args.delta_frame, args.case) == \
        (128, 6, 5, 12, 5e-4, 1e-10, 30, "run")
    assert motion_main.DEFAULT_CONFIG.read_text() == \
        jax_motion_main.DEFAULT_CONFIG.read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        motion_main.main(motion_main.get_args(["--data_dir",
                                               str(tmp_path)]))
