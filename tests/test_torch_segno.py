"""The port's SEGNO against the JAX package: the weight-tied GCL (its dense
path and its route through the fused chain with the per-edge clip), its
gradients, the invariant temporal attention, the model (one input, several
inputs fused by sum and by attention, per-batch segment lengths), the
weight converter, and SEGNOExperiment's epochs and test rollout.

Inputs come from numpy seeds; JAX weights come from ``.init(PRNGKey)`` and
reach the port through compat.params. The JAX fused GCL runs its Pallas
kernel in interpret mode, as tests/test_pallas_fused.py runs it. Tolerances,
each with its reason, sit beside the tests that use them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.compat.torch_port import segno_params_from_state_dict
from nonode_tpu.data.nbody import NBodyDataset as JaxNBodyDataset
from nonode_tpu.models.segno import SEGNO as JaxSEGNO
from nonode_tpu.models.segno import InvariantTemporalAttention as JaxAttn
from nonode_tpu.ops.dense_graph import SEGNOGCL as JaxGCL
from nonode_tpu.train.loop import SEGNOExperiment as JaxExperiment
from nonode_tpu.train.loop import make_perm as jax_make_perm
from nonode_tpu_torch.compat.params import segno_state_dict_from_jax_params
from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.segno import SEGNO, InvariantTemporalAttention
from nonode_tpu_torch.ops.dense_graph import SEGNOGCL
from nonode_tpu_torch.ops.kernels import egnn_fused
from nonode_tpu_torch.train.loop import SEGNOExperiment, make_perm
from torch_port_util import (assert_close, mlp_sd, t, write_charged_split,
                             write_gravity_split)

H, E, N = 16, 2, 5


def assert_scaled(actual, expected, rel):
    """|actual - expected| <= rel x (|expected| + max(1, max|expected|)): fp32
    in another order, whose rounding scales with the tensor's largest
    entry (the clip cases' coordinate head is scaled by 1e6)."""
    expected = np.asarray(expected)
    scale = max(1.0, float(np.abs(expected).max()))
    assert_close(actual, expected, rtol=rel, atol=rel * scale)


def _gcl_sd(p):
    """A JAX SEGNOGCL tree as the port's SEGNOGCL state_dict."""
    sd = {}
    sd.update(mlp_sd("edge_mlp", p["edge_mlp"]))
    sd.update(mlp_sd("node_mlp", p["node_mlp"]))
    sd.update(mlp_sd("coord_mlp", {"l1": p["coord_mlp_l1"],
                                   "l2": p["coord_mlp_l2"]}))
    return sd


def _state(lead, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*lead, *s).astype(np.float32)   # noqa: E731
    return f(N, H), f(N, 3), f(N, 3), f(N, N, E)             # h, x, v, eattr


GCL_CASES = {
    "plain": dict(),
    "coords_weight": dict(coords_weight=0.7),
    "clip": dict(coords_weight=0.7, head_scale=1e6),
    "tanh": dict(tanh=True),
}


def _gcl_pair(case, fused):
    kw = dict(GCL_CASES[case])
    head_scale = kw.pop("head_scale", 1.0)
    jl = JaxGCL(H, in_edge_nf=E, **kw)
    p = jl.init(jax.random.PRNGKey(3))
    p["coord_mlp_l2"]["w"] = p["coord_mlp_l2"]["w"] * head_scale
    layer = SEGNOGCL(H, E, fused=fused, device="cpu", **kw)
    layer.load_state_dict(_gcl_sd(p), strict=True)
    return jl, p, layer


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("case", list(GCL_CASES))
def test_gcl_step_matches_jax(case, fused):
    """One integrator step against JAX's dense SEGNOGCL and, where the gate
    admits it, its fused route (the Pallas kernel in interpret mode).
    Tolerance 1e-5 x max(1, max|ref|): fp32, sums over 4 edges and H = 16
    products in another order. "clip" scales the coordinate head by 1e6 so
    that edges clip; tanh=True takes the dense path on both sides."""
    jl, p, layer = _gcl_pair(case, fused)
    h, x, v, ea = _state((4,), seed=1)
    want = jl(p, *map(jnp.asarray, (h, x, v, ea)), 0.125)
    if fused and not GCL_CASES[case].get("tanh"):
        assert layer._use_fused(t(x), t(ea))
        jfused = dataclasses.replace(jl, fused=True)
        assert jfused._use_fused(jnp.asarray(x), jnp.asarray(ea), None)
        got_jax_fused = jfused(p, *map(jnp.asarray, (h, x, v, ea)), 0.125)
        for a, b in zip(got_jax_fused, want):
            assert_scaled(a, b, 1e-5)
    else:
        assert not layer._use_fused(t(x), t(ea))
    with torch.no_grad():
        got = layer(*map(t, (h, x, v, ea)), 0.125)
    for a, b in zip(got, want):
        assert_scaled(a, b, 1e-5)
    if case == "clip":
        # the clip engaged: forces of about 1e6 x |r_ij| per edge, each
        # clipped to +-100, averaged and scaled by coords_weight
        agg = (np.asarray(want[2]) - v) * 8.0
        assert np.abs(agg).max() > 10.0
        assert np.abs(agg).max() <= 70.0 + 1e-3


def test_gcl_reads_the_reference_column_order():
    """The edge MLP's first Linear takes [h_i, h_j, radial, edge_attr]: with
    the radial and edge columns of EGNN's order ([radial, h_i, h_j, e]) the
    fused route would read other weights. Swapping h_i's and h_j's columns
    must change the step (the weights are not symmetric)."""
    jl, p, layer = _gcl_pair("plain", True)
    h, x, v, ea = _state((2,), seed=2)
    with torch.no_grad():
        base = layer(*map(t, (h, x, v, ea)), 0.1)
        w = layer.edge_mlp[0].weight
        w.copy_(torch.cat([w[:, H:2 * H], w[:, :H], w[:, 2 * H:]], dim=1))
        swapped = layer(*map(t, (h, x, v, ea)), 0.1)
    assert float((base[0] - swapped[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("case", ["plain", "clip"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_gcl_gradients_match_jax(fused, case):
    """Gradients of every parameter and of h, x, v and edge_attr through one
    step (the fused route's backward is the chain's plain backward on the
    CPU) against jax.grad of JAX's dense step. Tolerance 1e-4 relative to
    each tensor's largest entry."""
    jl, p, layer = _gcl_pair(case, fused)
    h, x, v, ea = _state((3,), seed=4)
    rng = np.random.RandomState(5)
    ch, cx, cv = (rng.randn(*a.shape).astype(np.float32) for a in (h, x, v))

    def jloss(p, h, x, v, ea):
        ho, xo, vo = jl(p, h, x, v, ea, 0.125)
        return (ho * ch).sum() + (xo * cx).sum() + (vo * cv).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        p, *map(jnp.asarray, (h, x, v, ea)))
    ins = [t(a).requires_grad_() for a in (h, x, v, ea)]
    ho, xo, vo = layer(*ins, 0.125)
    ((ho * t(ch)).sum() + (xo * t(cx)).sum() + (vo * t(cv)).sum()).backward()
    want = _gcl_sd(jax.tree.map(np.asarray, jg[0]))
    named = dict(layer.named_parameters())
    assert set(named) == set(want)
    for k, prm in named.items():
        assert_scaled(prm.grad, want[k], 1e-4)
    for a, b in zip(ins, jg[1:]):
        assert_scaled(a.grad, b, 1e-4)


def test_invariant_temporal_attention_matches_jax():
    ja = JaxAttn(H, 8)
    p = ja.init(jax.random.PRNGKey(6))
    rng = np.random.RandomState(7)
    vel = rng.randn(2, 3, N, 3).astype(np.float32)
    his = rng.randn(2, 3, N, H).astype(np.float32)
    want = ja(p, jnp.asarray(vel), jnp.asarray(his))
    attn = InvariantTemporalAttention(H, 8, device="cpu")
    attn.load_state_dict(mlp_sd("attn_mlp", p), strict=True)
    with torch.no_grad():
        got = attn(t(vel), t(his))
    assert got.shape == (2, 3, N, 1)
    assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert_close(got.sum(0), np.ones((3, N, 1)), rtol=0, atol=1e-6)


def _models(agg=None, seed=0):
    jm = JaxSEGNO(hidden_nf=H, multiple_agg=agg)
    params = jm.init(jax.random.PRNGKey(seed))
    model = SEGNO(hidden_nf=H, multiple_agg=agg, device="cpu")
    model.load_state_dict(segno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, model


def _inputs(lead, seed):
    """his (|v|), x, v and the edge attributes of the last snapshot."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, N, 3).astype(np.float32)
    v = rng.randn(*lead, N, 3).astype(np.float32)
    his = np.sqrt((v ** 2).sum(-1, keepdims=True))
    q = rng.choice([-1.0, 1.0], (lead[-1], N, 1))
    last = x.reshape(-1, *x.shape[-3:])[-1]
    d2 = ((last[:, :, None] - last[:, None]) ** 2).sum(-1, keepdims=True)
    ea = np.concatenate([np.einsum("bik,bjk->bij", q, q)[..., None], d2], -1)
    return his, x, v, ea.astype(np.float32)


# fp32 in another order through up to 10 + 5 weight-tied steps
FWD_TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("agg", [None, "sum", "attn"],
                         ids=["single", "sum", "attn"])
def test_forward_matches_jax(agg):
    """One input, and three inputs at the non-uniform offsets (0, 2, 5),
    so segments of 2, 3 and T = 10 steps, fused by sum or by attention."""
    jm, params, model = _models(agg, seed=1)
    lead = (3,) if agg is None else (3, 3)
    his, x, v, ea = _inputs(lead, seed=2)
    in_steps = None if agg is None else (0, 2, 5)
    jx, jh, jv = jm(params, *map(jnp.asarray, (his, x, v, ea)), T=10,
                    in_steps=in_steps)
    with torch.no_grad():
        got = model(*map(t, (his, x, v, ea)), T=10, in_steps=in_steps)
    assert got[0].shape == (3, N, 3)
    for a, b in zip(got, (jx, jh, jv)):
        assert_close(a, b, **FWD_TOL)


def test_hidden_256_forward_matches_jax():
    """SEGNO at hidden 256 (T=10 weight-tied steps, 3 graphs): a width the
    card runs on #1/#2's wide route, with the per-edge clip; the port's
    fused GCL (the plain version on the CPU) against JAX."""
    jm = JaxSEGNO(hidden_nf=256)
    params = jm.init(jax.random.PRNGKey(7))
    model = SEGNO(hidden_nf=256, device="cpu")
    model.load_state_dict(segno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    his, x, v, ea = _inputs((3,), seed=8)
    jx, jh, jv = jm(params, *map(jnp.asarray, (his, x, v, ea)), T=10)
    with torch.no_grad():
        got = model(*map(t, (his, x, v, ea)), T=10)
    assert got[1].shape[-1] == 256
    for a, b in zip(got, (jx, jh, jv)):
        assert_close(a, b, **FWD_TOL)


def test_forward_dynamic_matches_jax_masked_integration():
    """Per-batch segment lengths: JAX integrates max_interior steps and
    masks those past each traced length; the port runs exactly the host
    lengths. The values agree."""
    jm, params, model = _models("attn", seed=3)
    his, x, v, ea = _inputs((3, 2), seed=4)
    seg_lens = np.array([1, 2])
    jx, jh, jv = jm.forward_dynamic(
        params, *map(jnp.asarray, (his, x, v, ea)), jnp.asarray(seg_lens),
        T=10, max_interior=3)
    with torch.no_grad():
        got = model.forward_dynamic(*map(t, (his, x, v, ea)), seg_lens, T=10)
        by_steps = model(*map(t, (his, x, v, ea)), T=10, in_steps=(0, 1, 3))
    for a, b, c in zip(got, (jx, jh, jv), by_steps):
        assert_close(a, b, **FWD_TOL)
        assert torch.equal(a, c)
    with pytest.raises(ValueError, match="segment lengths"):
        model.forward_dynamic(*map(t, (his, x, v, ea)), [1], T=10)


@pytest.mark.parametrize("agg", [None, "attn"], ids=["single", "attn"])
def test_weight_converter_gives_the_reference_layout(agg):
    """The converted tree loads with strict=True, and the port's state_dict
    is the reference layout: nonode_tpu's own importer of reference
    checkpoints reads it back into the same JAX tree."""
    jm = JaxSEGNO(hidden_nf=H, multiple_agg=agg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(8)))
    sd = segno_state_dict_from_jax_params(params)
    model = SEGNO(hidden_nf=H, multiple_agg=agg, device="cpu")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    back = segno_params_from_state_dict(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_seeded_init_is_reproducible_and_scales_the_head():
    a, b = (SEGNO(hidden_nf=H, device="cpu",
                  generator=torch.Generator().manual_seed(7)) for _ in "ab")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # xavier_uniform(gain=0.001) on [1, H]: |w| <= 0.001 sqrt(6 / (H + 1))
    head = a.module.coord_mlp[2].weight.detach()
    assert float(head.abs().max()) <= 0.001 * np.sqrt(6.0 / (H + 1))


# ---------- SEGNOExperiment against nonode_tpu's ----------

def _experiment(L=1, agg=None, seed=0, lr=1e-3, T=10, varDT=False):
    jm = JaxSEGNO(hidden_nf=H, multiple_agg=agg)
    jexp = JaxExperiment(jm, num_timesteps=T, lr=lr, weight_decay=1e-12)
    params, opt_state = jexp.init(jax.random.PRNGKey(seed))
    model = SEGNO(hidden_nf=H, multiple_agg=agg, device="cpu")
    model.load_state_dict(segno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    return jexp, params, opt_state, SEGNOExperiment(
        model, num_timesteps=T, varDT=varDT, lr=lr, weight_decay=1e-12)


def _split(d, partition, L, dataset="charged", s=12):
    write = write_charged_split if dataset == "charged" else \
        write_gravity_split
    write(d, "valid" if partition == "val" else partition, seed=2, s=s, f=55)
    kw = dict(partition=partition, num_inputs=L, dataset=dataset)
    return JaxNBodyDataset(d, **kw), NBodyDataset(d, device="cpu", **kw)


@pytest.mark.parametrize("L,varDT", [(1, False), (3, False), (3, True)],
                         ids=["single", "multi", "multi-varDT-epoch"])
def test_train_and_eval_epochs_match_jax(tmp_path, L, varDT):
    """Three Adam-L2 steps at lr 1e-3 from the same weights, then eval_epoch
    with the trained weights, against the JAX epochs on one draw of the
    steps (the permutation first, then the steps), that draw's frames in
    every batch; without varDT the port's draw_epoch gives the same
    permutation and windows from the same RandomState, and each batch the
    same input offsets. Losses: rtol 1e-5 (fp32 in another order; the
    steps' losses compound it), eval rtol 1e-4 as EGNO's epochs test."""
    jds, tds = _split(tmp_path, "train", L)
    jexp, params, opt_state, texp = _experiment(L, "attn" if L > 1 else None)
    rng_j = np.random.RandomState(9)
    perm_j = jax_make_perm(rng_j, len(jds), 4)
    frames_j, in_j, _ = jexp.input_frames(jds, jexp.sample_steps(jds, rng_j,
                                                                 varDT))
    windows = np.tile(frames_j, (len(perm_j), 1))
    if not varDT:
        perm_t, windows_t = texp.draw_epoch(tds, np.random.RandomState(9), 4)
        np.testing.assert_array_equal(perm_t, perm_j)
        np.testing.assert_array_equal(windows_t, windows)
    assert perm_j.shape == (3, 4)
    assert texp.batch(tds, windows, 2, torch.from_numpy(perm_j[2]))[5] == in_j
    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    jparams, _, jl = jexp.train_epoch(params, opt_state, arrays, perm_j,
                                      frames_j, in_j)
    tl, tlast = texp.train_epoch(tds, windows, perm_j)
    assert tl.shape == (3,)
    assert_close(tl, jl, rtol=1e-5, atol=0)
    assert_close(tlast, jl, rtol=1e-5, atol=0)
    je = jexp.eval_epoch(jparams, arrays, perm_j, frames_j, in_j)
    te, _ = texp.eval_epoch(tds, windows, perm_j)
    assert_close(te, je, rtol=1e-4, atol=0)


@pytest.mark.parametrize("dataset", ["charged", "gravity"])
def test_dynamic_epochs_match_jax(tmp_path, dataset):
    """varDT with several inputs: the port's draw_epoch draws the segment
    lengths per batch as JAX's sample_steps_batched and frames_from_steps
    do (gravity windows from frame 0 are pushed forward); its epochs run
    each batch's segments, JAX's dynamic epochs mask max_interior steps.
    Three Adam steps and an eval epoch, tolerances as above."""
    jds, tds = _split(tmp_path, "train", 3, dataset)
    jexp, params, opt_state, texp = _experiment(3, "attn", seed=2,
                                                varDT=True)
    rng_j = np.random.RandomState(4)
    perm_j = jax_make_perm(rng_j, len(jds), 4)
    frames_j = jexp.frames_from_steps(jds, jexp.sample_steps_batched(
        jds, rng_j, True, len(perm_j)))
    perm_t, frames_t = texp.draw_epoch(tds, np.random.RandomState(4), 4)
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_array_equal(frames_t, frames_j)
    assert len({tuple(np.diff(f)) for f in frames_t}) > 1, \
        "every batch drew the same segments"
    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    mi = jexp.max_interior(jds)
    jparams, _, jl = jexp.train_epoch_dynamic(
        params, opt_state, arrays, perm_j, jnp.asarray(frames_j), mi)
    tl, _ = texp.train_epoch(tds, frames_t, perm_t)
    assert_close(tl, jl, rtol=1e-5, atol=0)
    je = jexp.eval_epoch_dynamic(jparams, arrays, perm_j, mi,
                                 jnp.asarray(frames_j))
    te, _ = texp.eval_epoch(tds, frames_t, perm_t)
    assert_close(te, je, rtol=1e-4, atol=0)


@pytest.mark.parametrize("dataset,L,varDT", [
    ("charged", 1, False), ("charged", 3, False), ("charged", 3, True),
    ("gravity", 3, True)],
    ids=["single", "multi", "multi-varDT", "gravity-multi-varDT"])
def test_test_rollout_matches_jax(tmp_path, dataset, L, varDT):
    """The test rollout's artifact: per-batch windows from one RandomState,
    the sliding multi-input window with its shifting in_steps, the worst-case
    window count and (gravity, windows pushed forward) the shifted target
    anchoring. Tolerance 1e-4: two fed-back windows of 10 steps each."""
    write = write_charged_split if dataset == "charged" else \
        write_gravity_split
    write(tmp_path, "test", seed=5, s=8, f=55)
    kw = dict(partition="test", num_inputs=L, dataset=dataset, traj_len=2)
    jexp, params, _, texp = _experiment(L, "attn" if L > 1 else None, seed=6,
                                        varDT=varDT)
    jloss, jsteps, jart = jexp.test_rollout(
        params, JaxNBodyDataset(tmp_path, **kw), 4, np.random.RandomState(3),
        2, varDT)
    loss, steps, art = texp.test_rollout(
        NBodyDataset(tmp_path, device="cpu", **kw), 4,
        np.random.RandomState(3))
    assert art["preds"].shape == (8, 2, N, 3)
    assert art["energy_conservation"].shape == (8, 2, 1)
    assert np.isfinite(art["preds"]).all()
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert steps == pytest.approx(jsteps)
    for key in ("targets", "preds", "energy_conservation"):
        np.testing.assert_allclose(art[key], jart[key], rtol=1e-4, atol=1e-4)
    for key in ("finite_fraction", "test_loss_finite"):
        assert float(art[key]) == pytest.approx(jart[key], rel=1e-4)


def test_fused_route_counts_no_launch_on_the_cpu():
    """On the CPU the GCL's fused route takes the chain's plain versions:
    a training step counts no kernel launch."""
    _, _, model = _models(seed=9)
    his, x, v, ea = _inputs((2,), seed=9)
    before = (egnn_fused.pairwise_message.launches,
              egnn_fused.pairwise_message_bwd.launches)
    xo, _, _ = model(*map(t, (his, x, v, ea)), T=10)
    xo.sum().backward()
    assert model.embedding.weight.grad is not None
    assert (egnn_fused.pairwise_message.launches,
            egnn_fused.pairwise_message_bwd.launches) == before
