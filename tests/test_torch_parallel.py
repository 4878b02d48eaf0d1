"""The port's ``--dp``/``--space`` (nonode_tpu_torch/parallel/mesh.py)
against the JAX package's mesh (nonode_tpu/parallel/mesh.py) on the CPU:
the rank layout, the receiver slices of the pairwise chain, one sharded
training step of each model, and the driver.

The port's ranks are ``gloo`` processes on the CPU, started by
``mesh.launch``; JAX runs in the test process on its 8 virtual devices
(tests/conftest.py). A rank that runs a function of this file imports this
file, so JAX and nonode_tpu are imported inside the tests only.

Tolerances, set before the first run: the slices' rows within 1e-5 x max(1,
max|ref|) of JAX's Pallas op (interpret mode) and their gradients, summed
over the slices, within 1e-4 of ``jax.vjp``; a sharded step's loss within
rtol 1e-5 and its parameters within rtol 1e-4 / atol 1e-5 of JAX's
sharded step (tests/test_parallel.py:27-67 holds JAX's own to these); the
drivers within ``_training_main_matches_jax``'s rel 1e-4.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nonode_tpu_torch import main as tmain
from nonode_tpu_torch.ops.kernels import egnn_fused
from nonode_tpu_torch.parallel import mesh as meshes

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---- the layout ----

@pytest.mark.parametrize("n,space", [(2, 1), (4, 2), (8, 2), (8, 4)])
def test_rank_layout_is_the_jax_mesh(n, space):
    """rank -> (d, s) is where nonode_tpu's make_mesh puts device ``rank``
    in its (data, space) grid (mesh.py:38: devices reshaped row-major)."""
    from nonode_tpu.parallel.mesh import make_mesh as jax_make_mesh

    grid = np.vectorize(lambda dev: dev.id)(jax_make_mesh(n,
                                                          space=space).devices)
    assert grid.shape == (n // space, space)
    for rank in range(n):
        m = meshes.Mesh(n // space, space, rank, CPU, "gloo", None, None,
                        None)
        assert grid[m.d, m.s] == rank


def _groups_on_rank(mesh):
    return (mesh.rank, mesh.d, mesh.s, mesh.backend,
            dist.get_process_group_ranks(mesh.space_group),
            dist.get_process_group_ranks(mesh.data_group))


def test_launch_builds_the_groups_of_the_grid():
    """4 gloo ranks as --dp 2 --space 2: a rank's space group is its row of
    the grid (same d), its data group its column (same s); rank 0's value
    comes back, and the backend rule picks gloo on the CPU."""
    backend, devices = meshes.placement(4, CPU)
    assert backend == "gloo" and devices == [CPU] * 4
    rank, d, s, backend, space_g, data_g = meshes.launch(
        _groups_on_rank, (), 2, 2, CPU)
    assert (rank, d, s, backend) == (0, 0, 0, "gloo")
    assert space_g == [0, 1] and data_g == [0, 2]
    assert len(meshes.launch.rank_launches) == 4


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    mesh.barrier()       # rank 0 waits in a collective for the failed rank
    return mesh.rank


def test_a_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank 1 fails"):
        meshes.launch(_fail_on_rank_1, (), 2, 1, CPU)


def test_dp_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    """No fallback: ``--dp 2`` on the default device raises before a rank
    starts when there is no CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(meshes, "launch", lambda *a: started.append(a))
    args = tmain.get_args(["--model", "egno", "--dp", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(args)
    assert not started


# ---- the receiver slices of the pairwise chain ----

def _chain_inputs(g, n, h, e, seed, coord_scale):
    rng = np.random.RandomState(seed)
    f = lambda *shape, scale=1.0: (scale * rng.randn(*shape)).astype(  # noqa: E731
        np.float32)
    b = 1.0 / np.sqrt(h)
    return (f(g, n, 3), f(g, n, h, scale=0.5), f(g, n, h, scale=0.5),
            f(g, n, n, e),
            (f(1, h, scale=0.3), f(e, h, scale=0.3), f(1, h, scale=0.1),
             f(h, h, scale=b), f(1, h, scale=0.1), f(h, h, scale=b),
             f(1, h, scale=0.1), f(h, 1, scale=coord_scale * b),
             f(1, 1, scale=0.1)))


@pytest.mark.parametrize("clip", [False, True], ids=["egno", "segno"])
def test_receiver_slices_of_the_chain_match_jax(clip):
    """N=4 over two slices of 2 receivers: each slice's rows of the fused
    chain (the autograd op, its plain version on the CPU) against the JAX
    Pallas op on the whole graphs; the gradients of x, hi, hj, efea and the
    nine weights, summed over the slices by autograd, against jax.vjp."""
    import jax
    import jax.numpy as jnp

    from nonode_tpu.ops.pallas.egnn_fused import pairwise_message

    g, n, h, e, space = 6, 4, 16, 2, 2
    x, hi, hj, efea, w = _chain_inputs(g, n, h, e, seed=7,
                                       coord_scale=400.0 if clip else 1.0)
    mask = 1.0 - np.eye(n, dtype=np.float32)
    rng = np.random.RandomState(8)
    gf = rng.randn(g, n, 3).astype(np.float32)
    gm = rng.randn(g, n, h).astype(np.float32)

    def jfn(x, hi, hj, efea, w):
        return pairwise_message(clip, x, hi, hj, efea, jnp.asarray(mask), w)

    (jf, jm), vjp = jax.vjp(jfn, *map(jnp.asarray, (x, hi, hj, efea)),
                            tuple(map(jnp.asarray, w)))
    jgrads = vjp((jnp.asarray(gf), jnp.asarray(gm)))

    tx, thi, thj, tefea = (_t(a).requires_grad_() for a in (x, hi, hj, efea))
    tw = tuple(_t(a).requires_grad_() for a in w)
    ni = n // space
    rows, total = [], 0.0
    for s in range(space):
        cut = slice(s * ni, (s + 1) * ni)
        f, m = egnn_fused.pairwise_message(
            clip, tx, thi[:, cut], thj, tefea[:, cut], _t(mask)[cut], tw,
            i0=s * ni)
        rows.append((f, m))
        total = total + (f * _t(gf)[:, cut]).sum() + (m * _t(gm)[:, cut]).sum()
    total.backward()
    for k, ref in enumerate((jf, jm)):
        got = torch.cat([r[k] for r in rows], 1).detach().numpy()
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    if clip:
        free = egnn_fused.pairwise_message_reference(
            False, *map(_t, (x, hi, hj, efea, mask)), tuple(map(_t, w)))[0]
        assert float((free - _t(np.asarray(jf))).abs().max()) > 1.0
    grads = [tx.grad, thi.grad, thj.grad, tefea.grad,
             *(p.grad for p in tw)]
    refs = [*jgrads[:4], *jgrads[4]]
    for got, ref in zip(grads, refs):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layer", ["egnn", "egnn-edge-mask", "segno-gcl",
                                   "segno-gcl-tanh"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_layers_on_receiver_slices_give_the_whole_graph(layer, fused):
    """EGNNLayer and SEGNOGCL on the receivers [i0, i0 + ni) (ReceiverRows,
    the senders handed over whole as the gather would) against the layer on
    the whole graphs: their rows within 1e-6 x max(1, max|whole|), on both
    the fused chain and the dense branch (taken with fused=False, with
    SEGNO's tanh, which the kernel gate refuses, and with a mask per
    graph), the diagonal masked at column i0 + i."""
    from nonode_tpu_torch.ops.dense_graph import (EGNNLayer, ReceiverRows,
                                                  SEGNOGCL)

    g, n, h, e, space = 3, 6, 16, 2, 3
    gen = torch.Generator().manual_seed(3)
    rng = np.random.RandomState(4)
    x, v = _t(rng.randn(g, n, 3)), _t(rng.randn(g, n, 3))
    hf, efea = _t(rng.randn(g, n, h)), _t(rng.randn(g, n, n, e))
    edge_mask = None
    if layer.startswith("egnn"):
        mod = EGNNLayer(h, e, with_v=True, fused=fused, device=CPU,
                        generator=gen)
        if layer == "egnn-edge-mask":
            edge_mask = _t(rng.rand(g, n, n) < 0.6)
        run = lambda x_, h_, v_, ef, em, rows: mod(  # noqa: E731
            x_, h_, ef, v=v_, edge_mask=em, rows=rows)
    else:
        mod = SEGNOGCL(h, e, tanh=layer.endswith("tanh"), fused=fused,
                       device=CPU, generator=gen)
        run = lambda x_, h_, v_, ef, em, rows: mod(  # noqa: E731
            h_, x_, v_, ef, 0.1, rows=rows)
    with torch.no_grad():
        whole = run(x, hf, v, efea, edge_mask, None)
        ni = n // space
        for s in range(space):
            cut = slice(s * ni, (s + 1) * ni)
            rows = ReceiverRows(i0=s * ni, n=n,
                                gather=lambda t: {3: x, h: hf}[t.shape[-1]],
                                node_sum=None)
            part = run(x[:, cut], hf[:, cut], v[:, cut], efea[:, cut],
                       edge_mask, rows)
            for a, b in zip(part, whole):
                ref = b[:, cut]
                assert float((a - ref).abs().max()) <= 1e-6 * max(
                    1.0, float(ref.abs().max()))


# ---- one sharded training step ----

def _port_experiment(kind, state):
    from nonode_tpu_torch.models.egno import EGNO
    from nonode_tpu_torch.models.segno import SEGNO
    from nonode_tpu_torch.train.loop import EGNOExperiment, SEGNOExperiment

    if kind == "egno":
        model = EGNO(n_layers=1, hidden_nf=8, num_timesteps=4,
                     time_emb_dim=4, num_modes=2, device=CPU)
        exp = EGNOExperiment(model)
    else:
        model = SEGNO(hidden_nf=8, device=CPU)
        exp = SEGNOExperiment(model, num_timesteps=3, lr=1e-3)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
    return exp


def _step_on_rank(mesh, kind, state, batch):
    """One step of make_sharded_train_step on this rank's share of the
    global numpy ``batch``; (the global loss, the parameters after it)."""
    exp = _port_experiment(kind, state)
    step = meshes.make_sharded_train_step(exp, mesh)
    batch = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                  for a in batch)
    loss = step(batch)
    return float(loss), {k: v.detach().numpy().copy()
                         for k, v in exp.model.state_dict().items()}


def _egno_reference(mesh, shard):
    """JAX's EGNO step through make_sharded_train_step on ``mesh``, at the
    inputs of tests/test_parallel.py:37-52: (state before, batch, loss,
    state after)."""
    import jax
    from nonode_tpu.models.egno import EGNO
    from nonode_tpu.parallel.mesh import (_egno_batch_shardings,
                                          make_sharded_train_step,
                                          shard_batch)
    from nonode_tpu.train.loop import EGNOExperiment
    from nonode_tpu_torch.compat.params import egno_state_dict_from_jax_params

    exp = EGNOExperiment(EGNO(n_layers=1, hidden_nf=8, num_timesteps=4,
                              time_emb_dim=4, num_modes=2))
    params, opt_state = exp.init(jax.random.PRNGKey(0))
    b, n, t, L = 16, 4, 4, 1
    rng = np.random.RandomState(0)
    batch = (
        rng.randn(b, L, n, 3).astype(np.float32),
        rng.randn(b, L, n, 3).astype(np.float32),
        rng.choice([-1.0, 1.0], (b, n, 1)).astype(np.float32),
        rng.randn(b, n, n, 1).astype(np.float32),
        rng.randn(b, t, n, 3).astype(np.float32),
        np.zeros((b, L), np.float32),
        np.broadcast_to(np.arange(1, t + 1, dtype=np.float32), (b, t)).copy(),
    )
    to_sd = lambda p: {k: v.numpy() for k, v in  # noqa: E731
                       egno_state_dict_from_jax_params(
                           jax.tree.map(np.asarray, p), 1).items()}
    before = to_sd(params)
    step = make_sharded_train_step(exp, mesh, shard_particles=shard)
    params, _, loss = step(params, opt_state, shard_batch(
        batch, _egno_batch_shardings(mesh, shard)))
    return before, batch, float(loss), to_sd(params)


def _segno_reference(mesh, shard):
    """JAX's SEGNO step: its epoch program with the mesh applied
    (apply_mesh: every batch sharding-constrained) over one batch of 16
    samples of 4 bodies; (state before, the batch, loss, state after)."""
    import jax
    import jax.numpy as jnp
    from nonode_tpu.models.segno import SEGNO
    from nonode_tpu.parallel.mesh import apply_mesh
    from nonode_tpu.train.loop import SEGNOExperiment
    from nonode_tpu_torch.compat.params import segno_state_dict_from_jax_params

    exp = SEGNOExperiment(SEGNO(hidden_nf=8, n_layers=4), num_timesteps=3,
                          lr=1e-3)
    params, opt_state = exp.init(jax.random.PRNGKey(1))
    apply_mesh(exp, mesh, shard_particles=shard)
    s, n, f = 16, 4, 10
    rng = np.random.RandomState(1)
    loc = rng.randn(s, 20, n, 3).astype(np.float32)
    vel = rng.randn(s, 20, n, 3).astype(np.float32)
    charges = rng.choice([-1.0, 1.0], (s, n, 1)).astype(np.float32)
    w = np.einsum("sik,sjk->sij", charges, charges)[..., None]
    to_sd = lambda p: {k: v.numpy() for k, v in  # noqa: E731
                       segno_state_dict_from_jax_params(
                           jax.tree.map(np.asarray, p)).items()}
    before = to_sd(params)
    params, _, losses = exp.train_epoch(
        params, opt_state, tuple(map(jnp.asarray, (loc, vel, charges, w))),
        jnp.arange(s)[None], (f,), None)
    batch = (loc[:, f], vel[:, f], charges, w, loc[:, f + 3], None)
    return before, batch, float(losses[0]), to_sd(params)


@pytest.mark.parametrize("kind", ["egno", "segno"])
@pytest.mark.parametrize("n_dev,space", [(2, 1), (4, 2)],
                         ids=["dp2", "dp2-space2"])
def test_sharded_step_matches_jax(kind, n_dev, space):
    """One training step through the port's ranks (dp = n_dev / space,
    space; weights crossed from JAX through compat/params.py) against JAX's
    sharded step on make_mesh(n_dev, space) (the particle axis sharded when
    space > 1): the loss within rtol 1e-5, every parameter after the step
    within rtol 1e-4 / atol 1e-5."""
    from nonode_tpu.parallel.mesh import make_mesh

    reference = _egno_reference if kind == "egno" else _segno_reference
    before, batch, jloss, jafter = reference(make_mesh(n_dev, space=space),
                                             space > 1)
    loss, after = meshes.launch(_step_on_rank, (kind, before, batch),
                                n_dev // space, space, CPU)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(after) == set(jafter)
    for name, ref in jafter.items():
        np.testing.assert_allclose(after[name], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ---- the driver ----

@pytest.mark.parametrize("model,extra,split", [
    ("egno", ["--dp", "2"], {}),
    ("segno", ["--dp", "2"], {}),
    ("egno", ["--n_balls", "4", "--dp", "2", "--space", "2"], {"n": 4}),
    ("segno", ["--n_balls", "4", "--dp", "2", "--space", "2",
               "--num_inputs", "2", "--varDT", "true"], {"n": 4}),
], ids=["egno-dp2", "segno-dp2", "egno-dp2-space2",
        "segno-dp2-space2-multi-varDT"])
def test_drivers_match_jax_on_a_mesh(tmp_path, model, extra, split):
    """Both drivers at the same --dp/--space (JAX on its virtual devices,
    the port on gloo ranks), trained two epochs from the JAX driver's
    seed-42 weights, validated, reloaded and rolled out; every loss and the
    artifact within rel 1e-4 (``_training_main_matches_jax``). SEGNO's
    two varDT inputs cut the batch on dim 1 of [L, B, N, 3]."""
    from test_torch_e2e import _training_main_matches_jax

    _training_main_matches_jax(tmp_path, "charged", model, extra, **split)


@pytest.mark.parametrize("mesh,n", [(["--dp", "2"], 5),
                                    (["--dp", "2", "--space", "2"], 4)],
                         ids=["dp2", "dp2-space2"])
def test_bf16_driver_on_a_mesh(tmp_path, mesh, n):
    """``--precision bf16`` for EGNO over the batch, and over the batch and
    the particles (the dense chain in bf16 on receiver slices, the senders
    gathered in bf16), against the port's own bf16 run in one process from
    the same weights: over the batch every loss within rtol 2e-4 (the
    gradients' sums over the batch in fp32, in two parts); over the
    particles within test_torch_bf16.py's rtol 5e-2, since the mean over the
    particle axis (EGNO's x_mean) is then two bf16 partial sums rounded
    apart (8 bits, about 4e-3 a rounding; 1.1e-3 seen on the loss). Against
    JAX's bf16 driver on the same mesh within that rtol 5e-2 too: the two
    packages round bf16 at other places, so the fp32 bound of 1e-4 does not
    apply."""
    from test_torch_bf16 import DRIVER_RTOL
    from test_torch_e2e import _run_both_drivers, _tiny_models

    from nonode_tpu_torch.train.checkpoint import save_params

    bodies = ["--n_balls", str(n)]
    extra = ["--precision", "bf16", *bodies, *mesh]
    stem, (jres, _), (res, out) = _run_both_drivers(tmp_path, "egno",
                                                    "charged", extra, n=n)
    outf = tmp_path / "one"
    save_params(outf / "tiny" / f"{stem}.ckpt", _tiny_models("egno"))
    one = tmain.main(tmain.get_args([
        "--model", "egno", "--only_test", "false", "--test_interval", "1",
        "--traj_len", "2", "--config_by_file", str(tmp_path / "tiny.json"),
        "--precision", "bf16", *bodies, "--outf", str(outf), "--device",
        "cpu", "--load_checkpoint", "true"]))
    ores = json.loads((outf / "tiny" / f"{stem}.json").read_text())
    rtol = DRIVER_RTOL if "--space" in mesh else 2e-4
    for key in ("train loss", "val loss", "test loss"):
        assert np.isfinite(res[key]).all(), key
        assert res[key] == pytest.approx(ores[key], rel=rtol), key
        assert res[key] == pytest.approx(jres[key], rel=DRIVER_RTOL), key
    assert out[2] == one[2] and out[0] == pytest.approx(one[0], rel=rtol)


def test_torchrun_ranks_join_its_group(tmp_path):
    """Under ``torchrun`` (RANK and WORLD_SIZE set) the driver's processes
    are the ranks: the results are those of the ranks ``main`` starts
    itself, and only rank 0 prints."""
    import subprocess
    import sys

    from torch_port_util import write_charged_split

    data = tmp_path / "data"
    data.mkdir()
    for seed, part in enumerate(("train", "valid", "test")):
        write_charged_split(data, part, seed=seed, s=8, f=55, n=4)
    argv = ["--model", "egno", "--only_test", "false", "--device", "cpu",
            "--data_dir", str(data), "--n_balls", "4", "--batch_size", "4",
            "--epochs", "2", "--test_interval", "1", "--traj_len", "2",
            "--dp", "2", "--space", "2"]
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nnodes", "1", "--nproc_per_node", "4", "-m",
         "nonode_tpu_torch.main", *argv, "--outf", str(tmp_path / "tr")],
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.count("Test Loss:") == 1
    best, test_loss, epoch = tmain.main(tmain.get_args(
        argv + ["--outf", str(tmp_path / "spawned")]))
    name = ("EGNO_charged_seed=42_n_part=4_n_inputs=1_dT_1_varDT=False_"
            "num_timesteps=10.json")
    res = json.loads((tmp_path / "tr" / "0exp_new" / name).read_text())
    assert res == json.loads((tmp_path / "spawned" / "0exp_new" / name)
                             .read_text())
    assert res["val loss"] == [best] and res["test loss"] == [test_loss]
