"""mocap's EGNO in the port (``motion_main.build_experiment``'s
``MotionExperiment``) against the benchmark's plain reference
(``h100_bench/reference/egno_mocap.py``) on seeded random weights, at a
small size on the CPU (nf 16, 2 layers, T=5, a batch of 3) on the written
skeleton's N=31 skeleton + 2-hop mask: the decoded frames, the loss, every
gradient and one Adam-L2 step. The port runs the plain versions of #1/#2
here; the reference is plain ``torch`` on dense [N, N] masks.

Tolerances, each a gap over the reference's own scale: the frames 1e-5 of
their largest value and the loss 1e-5 relative (float32 sums of up to 31
terms a node and 16 a unit in another order, through two layers and the
spectral convolutions: the gaps read 1e-7 and 0); each gradient 1e-5 of
its leaf's norm (float32 reordering through the backward: the worst leaf
reads 7e-7); the Adam step's change 2e-5 of its leaf's norm (Adam divides
each gradient by its own magnitude, so a unit whose gradient is small
moves by more than the gradient's relative gap: the worst leaf reads
1.9e-6). The fault cases show them tight: the reference on the complete
graph misses the frames by a whole unit of their scale, and with the
skeleton's and the 2-hop edges' attributes swapped by 2e-4."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from h100_bench.reference import egno_mocap as ref
from h100_bench.reference.common import AdamL2
from nonode_tpu_torch import motion_main
from nonode_tpu_torch.data.motion import MotionDynamicsDataset

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(nf=16, n_layers=2, num_timesteps=5, num_modes=2, time_emb_dim=32,
           in_node_nf=1, in_edge_nf=1)
LR, WD = 5e-4, 1e-10
FRAMES_TOL = LOSS_TOL = GRAD_TOL = 1e-5
STEP_TOL = 2e-5
IDX = torch.tensor([0, 77, 150])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The port's experiment with the reference's weights, a training
    split of the written run case, and the weights as the reference
    takes them."""
    d = tmp_path_factory.mktemp("mocap_ref")
    chip_smoke.write_mocap_case(d)
    ds = MotionDynamicsDataset(data_dir=d, partition="train",
                               max_samples=200, delta_frame=30, case="run",
                               num_timesteps=CFG["num_timesteps"])
    args = motion_main.get_args(["--device", "cpu", "--data_dir", str(d),
                                 "--nf", "16", "--n_layers", "2",
                                 "--lr", str(LR), "--weight_decay", str(WD)])
    exp = motion_main.build_experiment(args, torch.device("cpu"),
                                       torch.Generator().manual_seed(0))
    w = ref.draw_weights(CFG, 1, torch.Generator().manual_seed(5),
                         torch.device("cpu"))
    params = dict(exp.model.named_parameters())
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(t.shape[1:]) for n, t in w.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(w[n][0])
    return exp, ds, {n: t[0] for n, t in w.items()}


def _split(ds, **graph):
    return dict(dict(x0=ds.x_0, v0=ds.v_0, xt=ds.x_t,
                     edge_attr=ds.edge_attr, edge_mask=ds.edge_mask), **graph)


def _frames_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _leaf_gap(got, want):
    return float((got - want).norm() / want.norm())


def _leaves(w):
    return {n: t.clone().requires_grad_() for n, t in w.items()}


def test_the_written_skeleton_keeps_130_pairs(case):
    _, ds, _ = case
    mask = ds.edge_mask
    assert mask.shape == (31, 31) and int(mask.sum()) == 130
    assert torch.equal(mask, mask.T) and not mask.diagonal().any()
    assert sorted(ds.edge_attr[mask > 0].unique().tolist()) == [1.0, 2.0]


def test_frames_and_loss_match_the_reference(case):
    exp, ds, w = case
    batch = exp.batch(ds, None, 0, IDX)
    with torch.no_grad():
        got = exp.decode(batch)
        loss, _ = exp._loss(batch)
        p = _leaves(w)
        want = ref.forward(p, CFG, ds.x_0[IDX], ds.v_0[IDX], ds.edge_attr,
                           ds.edge_mask).transpose(0, 1)
        ref_loss, per_frame = ref.train_loss(p, CFG, _split(ds), IDX)
    assert got.shape == want.shape == (3, 5, 31, 3)
    assert _frames_gap(got, want) <= FRAMES_TOL
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL * float(ref_loss)
    assert per_frame.shape == (1,) and float(per_frame[0]) == \
        float(ref_loss)


@pytest.mark.parametrize("fault", ["complete_graph", "swapped_edge_attr"])
def test_a_wrong_graph_misses_the_frames_tolerance(case, fault):
    exp, ds, w = case
    a = ds.edge_attr
    graph = {"complete_graph": dict(edge_mask=1.0 - torch.eye(31)),
             "swapped_edge_attr": dict(
                 edge_attr=torch.where(a > 0, 3.0 - a, a))}[fault]
    split = _split(ds, **graph)
    with torch.no_grad():
        got = exp.decode(exp.batch(ds, None, 0, IDX))
        want = ref.forward(_leaves(w), CFG, ds.x_0[IDX], ds.v_0[IDX],
                           split["edge_attr"],
                           split["edge_mask"]).transpose(0, 1)
    assert _frames_gap(got, want) > 10 * FRAMES_TOL


def test_gradients_and_an_adam_step_match_the_reference(case):
    exp, ds, w = case
    params = dict(exp.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    try:
        batch = exp.batch(ds, None, 0, IDX)
        loss, _ = exp._loss(batch)
        exp.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        p = _leaves(w)
        ref_loss, _ = ref.train_loss(p, CFG, _split(ds), IDX)
        ref_grads = dict(zip(p, torch.autograd.grad(
            ref_loss, list(p.values()), allow_unused=True)))
        # the last layer's node MLP feeds no loss on either side
        unused = {n for n, g in ref_grads.items() if g is None}
        assert unused == {n for n, g in grads.items() if g is None} == \
            {n for n in p if n.startswith("layers.1.node_net.")}
        for n, g in ref_grads.items():
            if g is not None:
                assert _leaf_gap(grads[n], g) <= GRAD_TOL, n
        exp.step(batch)
        stepped = AdamL2({n: t.detach() for n, t in p.items()}, LR, WD).step(
            {n: t.detach() for n, t in p.items()}, ref_grads)
        for n, t in params.items():
            assert _leaf_gap(t.detach() - before[n],
                             stepped[n] - w[n]) <= STEP_TOL, n
    finally:
        with torch.no_grad():
            for n, t in params.items():
                t.copy_(before[n])


def test_the_reference_loads_without_jax_or_either_package():
    code = """
import sys
for name in ("jax", "jaxlib", "nonode_tpu", "nonode_tpu_torch"):
    sys.modules[name] = None          # an import of it would raise
import torch
from h100_bench.reference import egno_mocap as ref
cfg = dict(nf=8, n_layers=1, num_timesteps=5, num_modes=2, time_emb_dim=4,
           in_node_nf=1, in_edge_nf=1)
w = {n: t[0] for n, t in ref.draw_weights(
    cfg, 1, torch.Generator().manual_seed(0), torch.device("cpu")).items()}
mask = 1.0 - torch.eye(4)
x = ref.forward(w, cfg, torch.randn(2, 4, 3), torch.randn(2, 4, 3),
                mask[..., None], mask)
print(tuple(x.shape), sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "nonode_tpu",
                                                    "nonode_tpu_torch")
                             and sys.modules[m] is not None))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "(5, 2, 4, 3) []"
