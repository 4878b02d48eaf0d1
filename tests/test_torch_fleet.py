"""The port's seed fleets (parallel/fleet.py, fleet_main.py) and the seed
axis of the pairwise chain, against K sequential port runs and against the
JAX package's fleet.

- FleetEarlyStopping and eval_shard_indices: the decisions and splits of
  nonode_tpu/parallel/fleet.py (ports of tests/test_parallel.py:75-134).
- The plain seed-axis chain (forward and backward, with the clip) against K
  single-seed plain calls, and the vmap rule's one call per layer.
- SeedFleet epochs against K sequential port epochs (rtol 1e-5: the same
  fp32 arithmetic, batched), and against the JAX SeedFleet from crossed
  K-axis weights (1e-4: fp32 in another order, as the port's epoch tests).
- fleet_main end to end: compaction, the final-epoch evaluation, resume,
  and the multi-input / varDT fleets against the sequential driver per seed
  (best epoch equal, losses within 1e-4), as tests/test_driver.py:147-290
  holds the JAX fleet.
- The fleet's steps as CUDA graphs, with the capture stubbed on the CPU:
  which steps warm up, capture and replay, what makes a new key, and the
  eager fleet's bits (the card's graphs: tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.models.segno import SEGNO as JaxSEGNO
from nonode_tpu.parallel import fleet as jfleet
from nonode_tpu.data.nbody import NBodyDataset as JaxNBodyDataset
from nonode_tpu.train.loop import EGNOExperiment as JaxEGNOExperiment
from nonode_tpu.train.loop import SEGNOExperiment as JaxSEGNOExperiment
from nonode_tpu_torch import fleet_main as tfleet_main
from nonode_tpu_torch import main as tmain
from nonode_tpu_torch.compat.params import (egno_state_dict_from_jax_params,
                                            fleet_params_from_jax_params,
                                            segno_state_dict_from_jax_params)
from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.egno import EGNO
from nonode_tpu_torch.models.segno import SEGNO
from nonode_tpu_torch.ops.kernels import egnn_fused
from nonode_tpu_torch.parallel.fleet import (FleetEarlyStopping, SeedFleet,
                                             eval_shard_indices)
from nonode_tpu_torch.train.checkpoint import EarlyStopping
from nonode_tpu_torch.train.loop import EGNOExperiment, SEGNOExperiment
from torch_port_util import assert_close, write_charged_split


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: its tensors are tiny, and in a
    parallel test run a thread pool in every worker oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 2]


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    """Charged-5 splits of 24/16/16 samples x 55 frames."""
    d = tmp_path_factory.mktemp("fleet_data")
    for seed, (part, s) in enumerate((("train", 24), ("valid", 16),
                                      ("test", 16))):
        write_charged_split(d, part, seed=seed, s=s, f=55)
    return d


@pytest.fixture(scope="module")
def tiny_conf(tmp_path_factory):
    """A model_confs.yaml-schema file at a tiny width for the fleet_main
    runs (the drivers' --config), so that they stay quick on the CPU; EGNO
    at SEGNO's learning rate, so that patience 1 stops seeds within a few
    epochs."""
    p = tmp_path_factory.mktemp("fleet_conf") / "tiny.yaml"
    p.write_text("EGNO:\n  model_params: {n_layers: 2, hidden_nf: 16, "
                 "time_emb_dim: 8}\n  training_params: {lr: 5.0e-3}\n"
                 "SEGNO:\n  model_params: {hidden_nf: 16}\n")
    return p


# ---------- early stopping and the evaluation split ----------

def test_fleet_early_stopping_matches_sequential_decisions(tmp_path):
    """The same stop epochs, best values and best epochs as K sequential
    EarlyStopping instances, the exact-tie rule and NaN included; and the
    same decisions as the JAX FleetEarlyStopping."""
    rng = np.random.RandomState(0)
    k, e, patience = 5, 40, 3
    vals = rng.rand(k, e).astype(np.float64)
    vals[1, 5:] = vals[1, 5]             # an exact-tie plateau: never stops
    vals[2] = np.linspace(1.0, 0.1, e)   # monotone: never stops
    vals[3, 3:] = vals[3, 3] + 0.1       # stops at 3 + patience
    vals[4, 10:] = np.nan                # NaN "improves" in the reference

    fes, jfes = FleetEarlyStopping(k, patience), \
        jfleet.FleetEarlyStopping(k, patience)
    fleet_stop = np.full(k, -1)
    for ep in range(e):
        np.testing.assert_array_equal(fes(vals[:, ep], ep),
                                      jfes(vals[:, ep], ep))
        fleet_stop = np.where((fleet_stop < 0) & fes.stopped, ep, fleet_stop)
    for name in ("best_val", "best_epoch", "counter", "stopped"):
        np.testing.assert_array_equal(getattr(fes, name), getattr(jfes, name))

    module = nn.Linear(1, 1)
    for i in range(k):
        es = EarlyStopping(patience=patience, path=tmp_path / f"{i}.ckpt")
        seq_stop, seq_best_ep = -1, 0
        for ep in range(e):
            es(float(vals[i, ep]), module)
            if es.counter == 0:
                seq_best_ep = ep
            if es.early_stop:
                seq_stop = ep
                break
        assert fleet_stop[i] == seq_stop, f"seed {i}"
        np.testing.assert_allclose(fes.best_val[i], es.val_loss_min)
        assert fes.best_epoch[i] == seq_best_ep, f"seed {i}"
    assert not fes.all_stopped and fes.stopped[3]


@pytest.mark.parametrize("shuffle", [False, True])
def test_eval_shard_indices_match_jax(shuffle):
    """Strided, no padding, every index once; shuffled deterministically by
    seed + epoch; the JAX package's split exactly."""
    n, world = 23, 4
    shards = [eval_shard_indices(n, world, r, shuffle, 3, 5)
              for r in range(world)]
    for r, s in enumerate(shards):
        np.testing.assert_array_equal(
            s, jfleet.eval_shard_indices(n, world, r, shuffle, 3, 5))
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)),
                                  np.arange(n))
    if shuffle:
        assert not np.array_equal(
            shards[0], eval_shard_indices(n, world, 0, True, 3, 6))
    else:
        np.testing.assert_array_equal(shards[1], np.arange(1, n, world))


# ---------- the seed axis of the chain ----------

def _chain(k, b, n, h, e, seed, coord_scale):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: torch.tensor(sc * rng.randn(*s),   # noqa: E731
                                        dtype=torch.float32)
    x, hi, hj, efea = f(k * b, n, 3), f(k * b, n, h, sc=0.5), \
        f(k * b, n, h, sc=0.5), f(k * b, n, n, e)
    sets = [(f(1, h, sc=0.3), f(e, h, sc=0.3), f(1, h, sc=0.1),
             f(h, h, sc=h ** -0.5), f(1, h, sc=0.1), f(h, h, sc=h ** -0.5),
             f(1, h, sc=0.1), f(h, 1, sc=coord_scale * h ** -0.5),
             f(1, 1, sc=0.1)) for _ in range(k)]
    gtotf, gtotm = f(k * b, n, 3), f(k * b, n, h)
    return x, hi, hj, efea, sets, gtotf, gtotm


@pytest.mark.parametrize("clip_edges", [False, True])
def test_plain_seed_axis_chain_matches_single_seed_calls(clip_edges):
    """pairwise_message with K stacked weight sets (the plain seed-axis
    version on the CPU) against one plain call per seed, forward and
    backward; and its autograd gradients against the backward's."""
    k, b, n, h, e = 3, 4, 5, 16, 2
    x, hi, hj, efea, sets, gtotf, gtotm = _chain(
        k, b, n, h, e, 5, 400.0 if clip_edges else 1.0)
    mask = 1.0 - torch.eye(n)
    stacked = tuple(torch.stack(ws) for ws in zip(*sets))
    part = lambda t, s: t[s * b:(s + 1) * b]                   # noqa: E731
    totf, totm = egnn_fused.pairwise_message(clip_edges, x, hi, hj, efea,
                                             mask, stacked)
    got = egnn_fused.pairwise_message_bwd(clip_edges, x, hi, hj, efea, mask,
                                          stacked, gtotf, gtotm)
    for s in range(k):
        args = (*(part(t, s) for t in (x, hi, hj, efea)), mask, sets[s])
        want_f, want_m = egnn_fused.pairwise_message_reference(clip_edges,
                                                               *args)
        assert_close(part(totf, s), want_f, rtol=1e-5, atol=1e-5)
        assert_close(part(totm, s), want_m, rtol=1e-5, atol=1e-5)
        want = egnn_fused.pairwise_message_bwd_reference(
            clip_edges, *args, part(gtotf, s), part(gtotm, s))
        for a, w in zip(got[:4], want[:4]):
            scale = max(1.0, float(w.abs().max()))
            assert_close(part(a, s), w, rtol=1e-5, atol=1e-5 * scale)
        for a, w in zip(got[4], want[4]):
            scale = max(1.0, float(w.abs().max()))
            assert_close(a[s], w, rtol=1e-5, atol=1e-5 * scale)

    leaves = [t.clone().requires_grad_() for t in (x, hi, hj, efea,
                                                   *stacked)]
    out = egnn_fused.pairwise_message(clip_edges, *leaves[:4], mask,
                                      tuple(leaves[4:]))
    auto = torch.autograd.grad(out, leaves, (gtotf, gtotm))
    for a, w in zip(auto, (*got[:4], *got[4])):
        assert torch.equal(a, w)


def test_vmapped_layers_call_the_seed_axis_chain_once_per_layer(monkeypatch):
    """torch.vmap over stacked EGNO parameters: each layer's chain reaches
    the seed-axis op once for all K seeds, forward and backward, and the
    losses and gradients are each seed's own."""
    k, b, n = 3, 4, 5
    models = [EGNO(n_layers=2, hidden_nf=16, time_emb_dim=8,
                   num_timesteps=5, device="cpu",
                   generator=torch.Generator().manual_seed(s))
              for s in range(k)]
    params = {name: torch.stack([dict(m.named_parameters())[name].detach()
                                 for m in models]).requires_grad_()
              for name, _ in models[0].named_parameters()}
    calls = []
    for name in ("pairwise_message_seeds_reference",
                 "pairwise_message_bwd_seeds_reference"):
        orig = getattr(egnn_fused, name)
        monkeypatch.setattr(egnn_fused, name,
                            lambda *a, _o=orig, _n=name: calls.append(
                                (_n, a[1].shape[0])) or _o(*a))
    rng = np.random.RandomState(0)
    loc, vel = (torch.tensor(rng.randn(k, b, n, 3), dtype=torch.float32)
                for _ in "lv")
    nodes = torch.tensor(rng.randn(k, b, n, 2), dtype=torch.float32)
    ea = torch.tensor(rng.randn(k, b, n, n, 2), dtype=torch.float32)
    lm = loc.mean(-2, keepdim=True).expand(loc.shape)

    def one(p, *a):
        x, _, _ = torch.func.functional_call(models[0], p, a)
        return (x ** 2).mean()

    losses = torch.vmap(one)(params, loc, vel, nodes, ea, lm)
    losses.sum().backward()
    g = k * 5 * b                    # seeds x decoded frames x batch
    assert calls == [("pairwise_message_seeds_reference", g)] * 2 + \
        [("pairwise_message_bwd_seeds_reference", g)] * 2
    for s, m in enumerate(models):
        x, _, _ = m(loc[s], vel[s], nodes[s], ea[s], lm[s])
        loss = (x ** 2).mean()
        loss.backward()
        assert loss.item() == pytest.approx(losses[s].item(), rel=1e-6)
        for name, p in m.named_parameters():
            if p.grad is not None:
                assert_close(params[name].grad[s], p.grad, rtol=1e-5,
                             atol=1e-6)


# ---------- SeedFleet epochs ----------

def _egno_build(L=1, n_layers=2):
    kw = dict(n_layers=n_layers, hidden_nf=16, time_emb_dim=8, num_timesteps=5,
              num_modes=2, num_inputs=L, varDT=L > 1)
    return lambda g: EGNOExperiment(EGNO(device="cpu", generator=g, **kw),
                                    lr=1e-3, weight_decay=1e-8)


def _segno_build():
    return lambda g: SEGNOExperiment(
        SEGNO(hidden_nf=16, device="cpu", generator=g), num_timesteps=5,
        lr=1e-3, weight_decay=1e-12)


def _ds(d, partition, L=1, model="egno"):
    kw = dict(partition=partition, num_inputs=L, num_timesteps=5)
    if model == "egno":
        kw["varDT"] = L > 1
    return NBodyDataset(d, device="cpu", **kw)


@pytest.mark.parametrize("model,L", [("egno", 1), ("egno", 3),
                                     ("segno", 1)],
                         ids=["egno", "egno-multi-varDT", "segno"])
def test_seed_fleet_epoch_matches_sequential_epochs(tiny_data, model, L):
    """Each seed's per-batch losses, parameters and eval losses after one
    fleet epoch equal its own sequential epoch (rtol 1e-5); the fleet's
    initial weights are the sequential driver's at each --seed."""
    from nonode_tpu_torch.runtime import seed_everything
    build = _egno_build(L) if model == "egno" else _segno_build()
    ds, ds_val = _ds(tiny_data, "train", L, model), \
        _ds(tiny_data, "val", L, model)
    fleet = SeedFleet(build(seed_everything(SEEDS[0])), SEEDS)
    params, opt = fleet.init(lambda g: build(g).model)
    rngs = [np.random.RandomState(s) for s in SEEDS]
    drawn = [fleet.exp.draw_epoch(ds, r, 8) for r in rngs]
    perms = np.stack([p for p, _ in drawn])
    per_seed = L > 1
    windows = (tfleet_main._stack_windows([w for _, w in drawn])
               if per_seed else drawn[0][1])
    losses, last = fleet.train_epoch(params, opt, ds, windows, perms,
                                     per_seed)
    vperm, vwin = fleet.exp.draw_epoch(ds_val, np.random.RandomState(0), 8,
                                       shuffle=False)
    vwins = tfleet_main._stack_windows([vwin] * len(SEEDS)) if per_seed \
        else vwin
    vl, vlast = fleet.eval_epoch(params, ds_val, vwins, vperm, per_seed)
    for i, (s, (perm, win)) in enumerate(zip(SEEDS, drawn)):
        exp = build(seed_everything(s))
        for name, p in exp.model.named_parameters():
            assert torch.equal(fleet.split(fleet.init(
                lambda g: build(g).model)[0])[i][name], p.detach()), name
        tl, tlast = exp.train_epoch(ds, win, perm)
        assert_close(losses[i], tl, rtol=1e-5, atol=0)
        assert_close(last[i], tlast, rtol=1e-5, atol=0)
        for name, p in exp.model.named_parameters():
            assert_close(params[name][i].detach(), p.detach(), rtol=1e-5,
                         atol=1e-6)
        el, elast = exp.eval_epoch(ds_val, vwin, vperm)
        assert_close(vl[i], el, rtol=1e-5, atol=0)
        assert_close(vlast[i], elast, rtol=1e-5, atol=0)


def _jax_split(d, partition, model="egno"):
    kw = dict(partition=partition, num_timesteps=5)
    return JaxNBodyDataset(d, **kw)


@pytest.mark.parametrize("model", ["egno", "segno"])
def test_seed_fleet_epoch_matches_jax_fleet(tiny_data, model):
    """The JAX SeedFleet's K-axis weights crossed into the port
    (compat.params.fleet_params_from_jax_params): the first step's loss of
    every seed, a fleet epoch's per-batch losses and the eval epoch after it
    within 1e-4 of JAX's, on the same permutations."""
    jds, jval = _jax_split(tiny_data, "train"), _jax_split(tiny_data, "val")
    ds, ds_val = _ds(tiny_data, "train", model=model), \
        _ds(tiny_data, "val", model=model)
    if model == "egno":
        jm = JaxEGNO(n_layers=1, hidden_nf=16, time_emb_dim=8,
                     num_timesteps=5, num_modes=2)
        jexp = JaxEGNOExperiment(jm, lr=1e-3, weight_decay=1e-8)
        convert = lambda p: egno_state_dict_from_jax_params(p, 1)  # noqa: E731
        build = _egno_build(n_layers=1)
    else:
        jm = JaxSEGNO(hidden_nf=16)
        jexp = JaxSEGNOExperiment(jm, num_timesteps=5, lr=1e-3,
                                  weight_decay=1e-12)
        convert = segno_state_dict_from_jax_params
        build = _segno_build()
    jf = jfleet.SeedFleet(jexp, SEEDS)
    jparams, jopt = jf.init()
    fleet = SeedFleet(build(torch.Generator().manual_seed(0)), SEEDS)
    params = {name: p.requires_grad_() for name, p in
              fleet_params_from_jax_params(
                  convert, jax.tree.map(np.asarray, jparams)).items()}
    assert set(params) == set(dict(fleet.exp.model.named_parameters()))
    opt = fleet.optimizer(params)
    perms = fleet.make_perms([np.random.RandomState(s) for s in SEEDS],
                             len(ds), 8)
    vperm = np.arange(16).reshape(2, 8)
    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    varrays = (jval.loc, jval.vel, jval.charges, jval.edge_weights)
    rng = np.random.RandomState(0)
    windows = fleet.exp.windows(ds, rng, perms.shape[1])
    vwin = fleet.exp.windows(ds_val, rng, 2)

    if model == "egno":
        idx = {k: jnp.asarray(v) for k, v in
               jexp.epoch_index_arrays(jds, rng).items()}
        vidx = {k: jnp.asarray(v) for k, v in
                jexp.epoch_index_arrays(jval, rng).items()}
        jp, _, jl, _ = jf.train_epoch(jparams, jopt, arrays, idx,
                                      jnp.asarray(perms))
        _, jv = jf.eval_epoch(jp, varrays, vidx, jnp.asarray(vperm))
    else:
        frames, in_steps, _ = jexp.input_frames(jds, None)
        jp, _, jl = jf.train_epoch_segno(jparams, jopt, arrays,
                                         jnp.asarray(perms), frames, in_steps)
        jv = jf.eval_epoch_segno(jp, varrays, jnp.asarray(vperm), frames,
                                 in_steps)
    losses, _ = fleet.train_epoch(params, opt, ds, windows, perms)
    # batch 0's loss of each seed is taken before any update: the crossed
    # weights give JAX's first-step loss
    assert_close(losses[:, 0], np.asarray(jl)[:, 0], rtol=1e-4, atol=0)
    assert_close(losses, jl, rtol=1e-4, atol=0)
    _, vlast = fleet.eval_epoch(params, ds_val, vwin, vperm)
    assert_close(vlast, jv, rtol=1e-4, atol=0)


def test_take_compacts_parameters_and_adam_state(tiny_data):
    """After an epoch, ``take`` keeps seeds 0 and 2: their parameters and
    Adam moments move over unchanged (the step count too), and the next
    epoch of the compacted fleet equals that of the full fleet on those
    seeds."""
    build = _egno_build()
    ds = _ds(tiny_data, "train")
    fleet = SeedFleet(build(torch.Generator().manual_seed(0)), SEEDS)
    params, opt = fleet.init(lambda g: build(g).model)
    windows = fleet.exp.windows(ds, None, 3)
    rngs = [np.random.RandomState(s) for s in SEEDS]
    fleet.train_epoch(params, opt, ds, windows,
                      fleet.make_perms(rngs, len(ds), 8))
    keep = [0, 2]
    small, small_opt = fleet.take(params, opt, keep)
    for name, p in params.items():
        q = small[name]
        assert q.requires_grad and q.is_leaf
        assert torch.equal(q.detach(), p.detach()[keep])
        if p.grad is None:      # the last layer's node MLP feeds no loss
            assert not opt.state[p] and not small_opt.state[q]
            continue
        st, st_small = opt.state[p], small_opt.state[q]
        assert torch.equal(st_small["step"], st["step"])
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st_small[key], st[key][keep])
    perms = fleet.make_perms(rngs, len(ds), 8)
    full, _ = fleet.train_epoch(params, opt, ds, windows, perms)
    part, _ = fleet.train_epoch(small, small_opt, ds, windows, perms[keep])
    assert_close(part, full[keep], rtol=1e-6, atol=0)
    for name in params:
        assert_close(small[name].detach(), params[name].detach()[keep],
                     rtol=1e-6, atol=1e-7)


# ---------- fleet_main ----------

def _fleet(tiny_data, tiny_conf, outf, *extra):
    return tfleet_main.main(tfleet_main.get_args([
        "--dataset", "charged", "--data_dir", str(tiny_data),
        "--config", str(tiny_conf),
        "--batch_size", "8", "--max_samples", "24", "--traj_len", "1",
        "--device", "cpu", "--outf", str(outf), *extra]))


@pytest.mark.parametrize("model", ["egno", "segno"])
def test_fleet_main_with_compaction(tiny_data, tiny_conf, tmp_path, model,
                                   capsys):
    """fleet_main end to end: patience 1
    stops seeds mid-run and compacts the fleet; every seed still gets its
    record, checkpoint and artifact, and its checkpoint loads into the
    sequential driver's model."""
    records = _fleet(tiny_data, tiny_conf, tmp_path, "--model", model,
                     "--epochs", "6",
                     "--test_interval", "1", "--patience", "1",
                     "--seeds", "1,2,3")
    out = capsys.readouterr().out
    assert "compacted fleet to" in out or "All seeds early-stopped" in out
    assert [r["seed"] for r in records] == [1, 2, 3]
    for r in records:
        assert np.isfinite(r["best_val_loss"]) and np.isfinite(r["test_loss"])
    run = tmp_path / "0exp_fleet"
    assert len(list(run.glob("*_results.npz"))) == 3
    ckpts = sorted(run.glob("*.ckpt"))
    assert len(ckpts) == 3
    args = tmain.get_args(["--model", model, "--device", "cpu",
                           "--config", str(tiny_conf)])
    exp = tmain.build_experiment(args, torch.device("cpu"),
                                 torch.Generator().manual_seed(0))
    exp.model.load_state_dict(torch.load(ckpts[0], weights_only=True),
                              strict=True)
    assert not list(run.glob("fleet_state_*"))


def test_fleet_final_epoch_eval(tiny_data, tiny_conf, tmp_path):
    """With test_interval past the last epoch the only evaluation is the
    forced final one (main.py's `or epoch == epochs - 1`)."""
    records = _fleet(tiny_data, tiny_conf, tmp_path, "--model", "segno",
                     "--epochs", "3", "--test_interval", "10",
                     "--seeds", "1,2")
    assert len(records) == 2
    for r in records:
        assert np.isfinite(r["best_val_loss"]) and r["best_epoch"] == 2


def test_fleet_resume_reproduces_uninterrupted_run(tiny_data, tiny_conf,
                                                   tmp_path):
    """A fleet that crashes after a saved state and is started again gives
    the uninterrupted run's records: parameters, Adam's state, the stopper,
    the compaction and every seed's rng stream round-trip."""
    common = ["--model", "egno", "--epochs", "6", "--test_interval", "1",
              "--seeds", "1,2", "--checkpoint_every", "2", "--patience", "2"]
    ref = _fleet(tiny_data, tiny_conf, tmp_path / "straight", *common)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _fleet(tiny_data, tiny_conf, tmp_path / "resumed", *common,
               "--_die_at_epoch", "3")
    state = list((tmp_path / "resumed" / "0exp_fleet")
                 .glob("fleet_state_*.pkl"))
    assert len(state) == 1, "no state saved before the crash"
    res = _fleet(tiny_data, tiny_conf, tmp_path / "resumed", *common)
    assert not state[0].exists()
    assert res == ref


@pytest.mark.parametrize("varDT", [False, True])
def test_fleet_multi_input_matches_sequential_driver(tiny_data, tiny_conf,
                                                     tmp_path, varDT):
    """EGNO fleets with two inputs: each seed draws from its own stream in
    the sequential driver's order (the train permutation, the train input
    offsets, the validation offsets, the test windows), so every seed's
    best epoch, best validation loss and test loss are the sequential
    driver's at that --seed (losses within 1e-4)."""
    common = ["--dataset", "charged", "--data_dir", str(tiny_data),
              "--epochs", "4", "--test_interval", "2", "--batch_size", "8",
              "--max_samples", "24", "--traj_len", "1", "--num_inputs", "2",
              "--varDT", str(varDT), "--device", "cpu",
              "--config", str(tiny_conf)]
    records = tfleet_main.main(tfleet_main.get_args(
        ["--model", "egno", "--seeds", "7,8",
         "--outf", str(tmp_path / "fleet"), *common]))
    for rec, seed in zip(records, (7, 8)):
        bv, tl, be = tmain.main(tmain.get_args(
            ["--model", "egno", "--only_test", "false", "--seed", str(seed),
             "--outf", str(tmp_path / f"seq{seed}"), *common]))
        assert rec["best_epoch"] == be, f"seed {seed}"
        assert rec["best_val_loss"] == pytest.approx(bv, rel=1e-4)
        assert rec["test_loss"] == pytest.approx(tl, rel=1e-4)


def test_fleet_main_refuses_segno_multi_input_and_keeps_the_guard(
        tiny_data, tiny_conf, tmp_path):
    """SEGNO multi-input/varDT fleets raise as in JAX; the memory guard's
    rule is the JAX driver's (nonode_tpu/fleet_main.py:139-157)."""
    with pytest.raises(NotImplementedError, match="sequential driver"):
        _fleet(tiny_data, tiny_conf, tmp_path, "--model", "segno",
               "--num_inputs", "3")
    cases = [(5, 256, 20, "egno", False, 32, True),
             (3, 128, 20, "segno", False, 64, False),
             (2, 128, 20, "segno", False, 128, False),
             (5, 256, 20, "egno", True, 256, False),
             (5, 256, 5, "egno", False, 256, False)]
    for k, b, n, model, off, want_b, want_remat in cases:
        args = tfleet_main.get_args(
            ["--model", model, "--batch_size", str(b), "--n_balls", str(n),
             "--seeds", ",".join(map(str, range(k)))]
            + (["--no_hbm_guard"] if off else []))
        tfleet_main.memory_guard(args, k)
        assert (args.batch_size, args.remat) == (want_b, want_remat), \
            (k, b, n, model, off)


def test_remat_gives_the_same_steps(tiny_data):
    """The fleet's remat (the whole vmapped loss recomputed in the backward)
    changes no number: the same losses and parameters after an epoch."""
    from nonode_tpu_torch.runtime import seed_everything
    build = _egno_build()
    ds = _ds(tiny_data, "train")
    windows = build(torch.Generator()).windows(ds, None, 3)
    perms = np.stack([np.random.RandomState(s).permutation(24).reshape(3, 8)
                      for s in SEEDS])
    runs = []
    for remat in (False, True):
        fleet = SeedFleet(build(seed_everything(SEEDS[0])), SEEDS,
                          remat=remat)
        params, opt = fleet.init(lambda g: build(g).model)
        losses, _ = fleet.train_epoch(params, opt, ds, windows, perms)
        runs.append((losses, params))
    (l0, p0), (l1, p1) = runs
    assert torch.equal(l0, l1)
    for name in p0:
        assert torch.equal(p0[name], p1[name])

# ---------- the fleet's steps as CUDA graphs (the capture stubbed) ----------

def _stub_capture(fleet):
    """Capture and replay on the CPU: the stub keeps the captured step
    without running it, and each replay runs it on the static input
    buffers, as a CUDA graph replays the kernels its capture recorded.
    Returns the list of the keys captured."""
    captured = []

    class CpuGraph:
        def __init__(self, key, body, inputs, keep):
            captured.append(key)
            self.key, self.body = key, body
            self.inputs = tuple(torch.empty(t.shape, dtype=t.dtype)
                                for t in inputs)

        def replay(self, inputs):
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)
            return tuple(o.clone() for o in self.body(*self.inputs))

    fleet._steps.devices = ("cpu",)
    fleet._steps.capture = CpuGraph
    return captured


def _kind(fleet, captured, run):
    """Whether ``run()``, one step, ran eagerly, captured or replayed."""
    c, r = len(captured), fleet.replays
    run()
    if len(captured) > c:
        return "capture"
    return "replay" if fleet.replays > r else "eager"


def _graph_fleet(tiny_data, model, graphed, remat=False):
    from nonode_tpu_torch.runtime import seed_everything
    build = _egno_build() if model == "egno" else _segno_build()
    fleet = SeedFleet(build(seed_everything(SEEDS[0])), SEEDS, remat=remat)
    captured = _stub_capture(fleet) if graphed else []
    params, opt = fleet.init(lambda g: build(g).model)
    ds = _ds(tiny_data, "train", model=model)
    return fleet, captured, params, opt, ds, fleet.exp.windows(ds, None, 3)


def _perms(epochs=2, b=8):
    rngs = [np.random.RandomState(s) for s in SEEDS]
    return np.concatenate([np.stack([r.permutation(24).reshape(-1, b)
                                     for r in rngs]) for _ in range(epochs)],
                          axis=1)


@pytest.mark.parametrize("model", ["egno", "segno"])
def test_graphed_steps_warm_up_capture_then_replay(tiny_data, model):
    """A key's first step runs eagerly, its second captures and replays,
    later ones replay; training and validation each keep their own graph.
    The graphed fleet's per-batch losses (one per step, all distinct),
    parameters, Adam moments and validation losses are the eager fleet's,
    bit for bit."""
    perms = _perms()
    runs = []
    for graphed in (False, True):
        fleet, captured, params, opt, ds, windows = _graph_fleet(
            tiny_data, model, graphed)
        ds_val = _ds(tiny_data, "val", model=model)
        vwin = fleet.exp.windows(ds_val, None, 2)
        vperm = np.arange(16).reshape(2, 8)
        kinds, losses, vals = [], [], []

        def train(b):
            losses.append(fleet.train_epoch(params, opt, ds, windows,
                                             perms[:, b:b + 1]))

        def val(b):
            vals.append(fleet.eval_epoch(params, ds_val, vwin,
                                         vperm[b:b + 1]))

        for b in range(3):
            kinds.append(_kind(fleet, captured, lambda: train(b)))
        for b in (0, 1, 0):
            kinds.append(_kind(fleet, captured, lambda: val(b)))
        for b in range(3, 6):
            kinds.append(_kind(fleet, captured, lambda: train(b)))
        runs.append((kinds, losses, vals, params, opt))
    (ek, el, ev, ep, eo), (gk, gl, gv, gp, go) = runs
    assert ek == ["eager"] * 9
    assert gk == ["eager", "capture", "replay", "eager", "capture",
                  "replay", "replay", "replay", "replay"]
    loss = torch.cat([t[0] for t in gl], 1)
    assert len(set(loss.flatten().tolist())) == loss.numel() == 6 * len(SEEDS)
    for a, w in zip(gl + gv, el + ev):
        assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])
    for name in ep:
        assert torch.equal(gp[name], ep[name]), name
        st, want = go.state[gp[name]], eo.state[ep[name]]
        assert set(st) == set(want), name
        for key in ("exp_avg", "exp_avg_sq"):
            if key in want:
                assert torch.equal(st[key], want[key]), (name, key)


@pytest.mark.parametrize("change", ["take", "storage", "batch", "remat"])
def test_a_changed_key_warms_up_and_captures_again(tiny_data, change):
    """After ``take`` (K and the storages change), a compaction that keeps
    every seed (the storages alone), another batch size, or ``remat``
    switched on, the next step runs eagerly, the one after captures anew
    (the old graph freed), and later ones replay."""
    fleet, captured, params, opt, ds, windows = _graph_fleet(
        tiny_data, "egno", True)
    state = dict(params=params, opt=opt, perms=_perms())

    def train(b):
        fleet.train_epoch(state["params"], state["opt"], ds, windows,
                          state["perms"][:, b:b + 1])

    kinds = [_kind(fleet, captured, lambda: train(b)) for b in range(3)]
    old = fleet._steps.graphs["train"]
    if change in ("take", "storage"):
        keep = [0, 2] if change == "take" else [0, 1, 2]
        state["params"], state["opt"] = fleet.take(params, opt, keep)
        state["perms"] = state["perms"][keep]
    elif change == "batch":
        state["perms"] = _perms(b=4)
    else:
        fleet.remat = True
    kinds += [_kind(fleet, captured, lambda: train(b)) for b in range(3, 6)]
    assert kinds == ["eager", "capture", "replay"] * 2
    assert fleet._steps.graphs["train"] is not old
    assert captured[0] != captured[1]


def test_the_key_holds_the_grad_mode_and_remat(tiny_data):
    fleet, _, params, _, ds, windows = _graph_fleet(tiny_data, "egno", True)
    idx = torch.from_numpy(_perms()[:, 0])

    def key():
        return fleet._key(params, ds, windows, 0, idx, False)

    with torch.no_grad():
        off = key()
    on = key()
    fleet.remat = True
    assert len({off, on, key()}) == 3
    assert fleet._key(params, ds, windows, 0, idx[0], False) != on


@pytest.mark.parametrize("case", ["per_seed_windows", "cpu"])
def test_per_seed_windows_and_the_cpu_stay_eager(tiny_data, case):
    """Per-seed windows (several inputs, varDT) are drawn anew every
    epoch and never graphed; on the CPU no step is."""
    from nonode_tpu_torch.runtime import seed_everything
    per_seed = case == "per_seed_windows"
    build = _egno_build(3 if per_seed else 1)
    fleet = SeedFleet(build(seed_everything(SEEDS[0])), SEEDS)
    captured = _stub_capture(fleet) if per_seed else []
    params, opt = fleet.init(lambda g: build(g).model)
    ds = _ds(tiny_data, "train", 3 if per_seed else 1)
    rngs = [np.random.RandomState(s) for s in SEEDS]
    for _ in range(2):
        drawn = [fleet.exp.draw_epoch(ds, r, 8) for r in rngs]
        windows = (tfleet_main._stack_windows([w for _, w in drawn])
                   if per_seed else drawn[0][1])
        fleet.train_epoch(params, opt, ds, windows,
                          np.stack([p for p, _ in drawn]), per_seed)
    assert fleet.replays == 0 and not captured and not fleet._steps.graphs
