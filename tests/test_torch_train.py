"""The port's training half against the JAX package: the pairwise chain's
backward, layer and model gradients, the spectral conv's weight gradient,
the Adam-L2 train and eval epochs, the permutation and early stopping.

Inputs come from numpy seeds; JAX weights come from ``.init(PRNGKey)`` and
reach the port through compat.params, and the same mapping applied to a JAX
gradient tree gives the gradients under the port's ``state_dict`` names.
Tolerances, each with its reason, sit beside the tests that use them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.data.nbody import NBodyDataset as JaxNBodyDataset
from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.ops import spectral as jspec
from nonode_tpu.ops.dense_graph import EGNNLayer as JaxEGNNLayer
from nonode_tpu.ops.pallas.egnn_fused import pairwise_message as jax_pairwise
from nonode_tpu.train.loop import EGNOExperiment as JaxExperiment
from nonode_tpu.train.loop import make_perm as jax_make_perm
from nonode_tpu_torch.compat.params import egno_state_dict_from_jax_params
from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.egno import EGNO
from nonode_tpu_torch.ops import spectral as tspec
from nonode_tpu_torch.ops.dense_graph import EGNNLayer
from nonode_tpu_torch.ops.kernels import egnn_fused
from nonode_tpu_torch.train.checkpoint import EarlyStopping, load_params
from nonode_tpu_torch.train.loop import EGNOExperiment, make_perm
from torch_port_util import (assert_close, egnn_layer_sd, t,
                             write_charged_split, write_gravity_split)



def assert_close_scaled(actual, expected, rel=1e-5):
    """|actual - expected| <= rel x (|expected| + max(1, max|expected|)):
    the chain's backward is fp32 on both sides with sums over <= 6 edges and
    H = 16 products taken in another order, and its weight gradients sum
    150 edge terms of up to a few hundred (the clip cases' large coordinate
    head), so their rounding scales with the tensor's largest entry."""
    expected = np.asarray(expected)
    scale = max(1.0, float(np.abs(expected).max()))
    assert_close(actual, expected, rtol=rel, atol=rel * scale)


def _chain_inputs(g, n, h, e, seed, coord_scale=1.0):
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)               # noqa: E731
    b = 1.0 / np.sqrt(h)
    x = f32(rng.randn(g, n, 3))
    hi, hj = f32(0.5 * rng.randn(g, n, h)), f32(0.5 * rng.randn(g, n, h))
    efea = f32(rng.randn(g, n, n, e))
    weights = (f32(0.3 * rng.randn(1, h)), f32(0.3 * rng.randn(e, h)),
               f32(0.1 * rng.randn(1, h)), f32(b * rng.randn(h, h)),
               f32(0.1 * rng.randn(1, h)), f32(b * rng.randn(h, h)),
               f32(0.1 * rng.randn(1, h)),
               f32(coord_scale * b * rng.randn(h, 1)),
               f32(0.1 * rng.randn(1, 1)))
    gtotf, gtotm = f32(rng.randn(g, n, 3)), f32(rng.randn(g, n, h))
    return x, hi, hj, efea, weights, gtotf, gtotm


def _mask(n, sparse):
    mask = 1.0 - np.eye(n, dtype=np.float32)
    if sparse:   # a 2-D mask with an isolated node (node 4)
        adj = (np.random.RandomState(3).rand(n, n) < 0.6).astype(np.float32)
        adj = np.maximum(adj, adj.T)
        adj[4, :] = adj[:, 4] = 0.0
        mask = mask * adj
    return mask


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("clip_edges", [False, True])
def test_plain_backward_matches_pallas_vjp(clip_edges, sparse):
    """pairwise_message_bwd_reference against jax.vjp of the Pallas op (its
    hand-written _bwd_kernel, interpret mode) and against torch.autograd
    through the plain forward."""
    g, n, h, e = 6, 5, 16, 2
    x, hi, hj, efea, weights, gtotf, gtotm = _chain_inputs(
        g, n, h, e, seed=7, coord_scale=400.0 if clip_edges else 1.0)
    mask = _mask(n, sparse)
    prim = (*map(jnp.asarray, (x, hi, hj, efea, mask)),
            tuple(map(jnp.asarray, weights)))
    _, vjp = jax.vjp(lambda *a: jax_pairwise(clip_edges, *a), *prim)
    jdx, jdhi, jdhj, jdefea, _, jdw = vjp((jnp.asarray(gtotf),
                                          jnp.asarray(gtotm)))

    args = (*map(t, (x, hi, hj, efea, mask)), tuple(map(t, weights)))
    got = egnn_fused.pairwise_message_bwd_reference(
        clip_edges, *args, t(gtotf), t(gtotm))
    for a, b in zip((*got[:4], *got[4]), (jdx, jdhi, jdhj, jdefea, *jdw)):
        assert tuple(a.shape) == tuple(b.shape)
        assert_close_scaled(a, b)

    leaves = [a.clone().requires_grad_() for a in (*args[:4], *args[5])]
    out = egnn_fused.pairwise_message_reference(
        clip_edges, *leaves[:4], args[4], tuple(leaves[4:]))
    auto = torch.autograd.grad(out, leaves, (t(gtotf), t(gtotm)))
    for a, b in zip((*got[:4], *got[4]), auto):
        assert_close_scaled(a, b)
    if clip_edges:
        unclipped = egnn_fused.pairwise_message_bwd_reference(
            False, *args, t(gtotf), t(gtotm))
        assert float((unclipped[0] - got[0]).abs().max()) > 1e-3, \
            "the clip never engaged"
    if sparse:
        # node 4 has no edge: nothing flows into its features
        assert float(got[1][:, 4].abs().max()) == 0.0
        assert float(got[2][:, 4].abs().max()) == 0.0


@pytest.mark.parametrize("clip_edges", [False, True])
def test_autograd_function_passes_gradcheck(clip_edges):
    """The autograd.Function (plain forward and backward on the CPU) in
    float64, against finite differences."""
    g, n, h, e = 2, 4, 6, 2
    rng = np.random.RandomState(1)
    leaf = lambda *s: torch.tensor(rng.randn(*s), dtype=torch.float64,  # noqa: E731
                                   requires_grad=True)
    x, hi, hj, efea = leaf(g, n, 3), leaf(g, n, h), leaf(g, n, h), \
        leaf(g, n, n, e)
    mask = 1.0 - torch.eye(n, dtype=torch.float64)
    mask[0, 3] = mask[3, 0] = 0.0
    ws = [leaf(1, h), leaf(e, h), leaf(1, h), leaf(h, h), leaf(1, h),
          leaf(h, h), leaf(1, h), leaf(h, 1), leaf(1, 1)]
    if clip_edges:   # forces of about 100: some edges clip, some do not
        with torch.no_grad():
            ws[7].mul_(60.0)
    fn = lambda *a: egnn_fused.pairwise_message(  # noqa: E731
        clip_edges, *a[:4], mask, tuple(a[4:]))
    assert torch.autograd.gradcheck(fn, (x, hi, hj, efea, *ws))


def test_backward_counts_no_launch_on_cpu_and_gives_mask_no_gradient():
    x, hi, hj, efea, weights, gtotf, gtotm = _chain_inputs(2, 5, 16, 2, 4)
    leaves = [t(a).requires_grad_() for a in (x, hi, hj, efea, *weights)]
    mask = t(_mask(5, False)).requires_grad_()
    before = (egnn_fused.pairwise_message.launches,
              egnn_fused.pairwise_message_bwd.launches)
    tf, tm = egnn_fused.pairwise_message(False, *leaves[:4], mask,
                                         tuple(leaves[4:]))
    ((tf * t(gtotf)).sum() + (tm * t(gtotm)).sum()).backward()
    assert (egnn_fused.pairwise_message.launches,
            egnn_fused.pairwise_message_bwd.launches) == before
    assert mask.grad is None
    assert all(leaf.grad is not None for leaf in leaves)


@pytest.mark.parametrize("with_v", [False, True])
def test_fused_layer_gradients_match_jax_dense_layer(with_v):
    """Gradients of the port's EGNNLayer on the fused route (the
    autograd.Function) w.r.t. its inputs and every parameter, against
    jax.grad of the JAX dense layer. The fused weights are slices and
    transposes of the Linear parameters: the gradient reaches each one."""
    n, h, e = 5, 16, 2
    jl = JaxEGNNLayer(h, e, with_v=with_v)
    params = jl.init(jax.random.PRNGKey(4))
    rng = np.random.RandomState(5)
    x, hh, v = (rng.randn(3, 4, n, k).astype(np.float32) for k in (3, h, 3))
    efea = rng.randn(4, n, n, e).astype(np.float32)
    cx = rng.randn(3, 4, n, 3).astype(np.float32)
    ch = rng.randn(3, 4, n, h).astype(np.float32)

    def jloss(p, x, hh, efea, v):
        xo, _, ho = jl(p, x, hh, efea, v=v if with_v else None)
        return (xo * cx).sum() + (ho * ch).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        params, *map(jnp.asarray, (x, hh, efea, v)))
    layer = EGNNLayer(h, e, with_v=with_v, fused=True, device="cpu")
    layer.load_state_dict(egnn_layer_sd(params), strict=True)
    ins = [t(a).requires_grad_() for a in (x, hh, efea, v)]
    assert layer._use_fused(ins[0], None)
    xo, _, ho = layer(*ins[:3], v=ins[3] if with_v else None)
    ((xo * t(cx)).sum() + (ho * t(ch)).sum()).backward()

    want = egnn_layer_sd(jax.tree.map(np.asarray, jg[0]))
    named = dict(layer.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        assert_close(p.grad, want[k], rtol=1e-4, atol=1e-5)
    for a, b in zip(ins[:3], jg[1:4]):
        assert_close(a.grad, b, rtol=1e-4, atol=1e-5)
    if with_v:
        assert_close(ins[3].grad, jg[4], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t_steps,modes", [(10, 2), (5, 3), (2, 2), (4, 3)])
def test_spectral_weight_gradient_matches_jax(t_steps, modes):
    """d/d weights1 through rfft, the complex mode product, the dropped
    imaginary parts of the zero-frequency term (and, at (2, 2) and (4, 3),
    of the Nyquist term) and irfft. Tolerance 2e-5: the FFTs round
    differently (pocketfft in JAX, torch's own on the CPU)."""
    rng = np.random.RandomState(t_steps)
    x = rng.randn(t_steps, 3, 4, 6).astype(np.float32)
    ct = rng.randn(t_steps, 3, 4, 6).astype(np.float32)
    conv = jspec.SpectralConv(6, 6, modes)
    p = conv.init(jax.random.PRNGKey(0))
    jg, jx = jax.grad(lambda p, x: (conv(p, x) * ct).sum(), argnums=(0, 1))(
        p, jnp.asarray(x))
    tc = tspec.SpectralConv(6, 6, modes, device="cpu")
    tc.load_state_dict({"weights1": t(p["w"])}, strict=True)
    xt = t(x).requires_grad_()
    (tc(xt) * t(ct)).sum().backward()
    assert_close(tc.weights1.grad, jg["w"], rtol=2e-5, atol=2e-5)
    assert_close(xt.grad, jx, rtol=2e-5, atol=2e-5)
    # the imaginary part of the zero-frequency weights has no effect, nor
    # has that of the Nyquist weights (a real input's Nyquist term is real)
    assert float(tc.weights1.grad[:, :, 0, 1].abs().max()) == 0.0
    if t_steps % 2 == 0 and modes > t_steps // 2:
        nyquist = tc.weights1.grad[:, :, t_steps // 2, 1]
        assert float(nyquist.abs().max()) == 0.0


def _models(n_layers=2, hidden=16, emb=8, seed=0, lr=1e-3, **kw):
    jm = JaxEGNO(n_layers=n_layers, hidden_nf=hidden, time_emb_dim=emb, **kw)
    jexp = JaxExperiment(jm, lr=lr, weight_decay=1e-8)
    params, opt_state = jexp.init(jax.random.PRNGKey(seed))
    model = EGNO(n_layers=n_layers, hidden_nf=hidden, time_emb_dim=emb,
                 device="cpu", **kw)
    model.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), n_layers), strict=True)
    return jexp, params, opt_state, EGNOExperiment(model, lr=lr,
                                                   weight_decay=1e-8)


def _split(tmp_path, partition="train", s=12, dataset="charged", **kw):
    write = write_charged_split if dataset == "charged" else \
        write_gravity_split
    write(tmp_path, partition, seed=2, s=s, f=55)
    kw.update(partition=partition, dataset=dataset)
    return (JaxNBodyDataset(tmp_path, **kw),
            NBodyDataset(tmp_path, device="cpu", **kw))


def _sd(tree, n_layers):
    return egno_state_dict_from_jax_params(jax.tree.map(np.asarray, tree),
                                           n_layers)


def test_loss_and_every_parameter_gradient_match_jax(tmp_path):
    """EGNOExperiment._loss and the gradient of every parameter (the time
    convs' weights1 included) on one batch, against
    jax.value_and_grad(EGNOExperiment._loss). Tolerance: rtol 1e-4 and atol
    1e-6 x max|g| per tensor, fp32 in another order through two layers and
    their FFTs."""
    jds, tds = _split(tmp_path)
    jexp, params, _, texp = _models()
    rng = np.random.RandomState(0)
    idx_np = jexp.epoch_index_arrays(jds, rng)
    idx = np.arange(6)
    jbatch = jexp._batch((jds.loc, jds.vel, jds.charges, jds.edge_weights),
                         {k: jnp.asarray(v) for k, v in idx_np.items()},
                         jnp.asarray(idx))
    (jloss, jlosses), jg = jax.value_and_grad(jexp._loss, has_aux=True)(
        params, jbatch)
    tbatch = texp._batch((tds.loc, tds.vel, tds.charges, tds.edge_weights),
                         {k: torch.from_numpy(v) for k, v in idx_np.items()},
                         torch.from_numpy(idx))
    loss, losses = texp._loss(tbatch)
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert_close(losses.detach(), jlosses, rtol=1e-5, atol=1e-7)
    want = _sd(jg, 2)
    named = dict(texp.model.named_parameters())
    assert set(named) == set(want)
    assert any(k.startswith("time_conv_modules") for k in named)
    for k, p in named.items():
        ref = want[k].numpy()
        if p.grad is None:   # the last layer's node MLP feeds no loss term
            assert k.startswith("layers.1.node_net"), k
            assert not ref.any(), k
            continue
        scale = float(np.abs(ref).max())
        assert_close(p.grad, ref, rtol=1e-4, atol=1e-6 * max(scale, 1.0))


def test_train_and_eval_epochs_match_jax(tmp_path):
    """Three Adam-L2 steps from the same weights on the same batches: the
    per-batch (loss, last-step loss), the parameters afterwards, and then
    eval_epoch. Losses: rtol 1e-5. Parameters: Adam divides by sqrt(v)+eps,
    so where a gradient is about eps (1e-8) the two sides' rounding can move
    an entry by up to lr in opposite directions; entries whose JAX gradient
    at step 1 exceeds 1e-6 (>> eps) are held to atol 1e-3 x lr, the rest to
    3 steps x 2 lr."""
    lr = 1e-3
    jds, tds = _split(tmp_path, s=12)
    jexp, params, opt_state, texp = _models(lr=lr)
    p0 = _sd(params, 2)
    rng_j, rng_t = np.random.RandomState(9), np.random.RandomState(9)
    perm_j = jax_make_perm(rng_j, len(jds), 4)
    idx_j = jexp.epoch_index_arrays(jds, rng_j)
    perm_t = make_perm(rng_t, len(tds), 4)
    idx_t = texp.epoch_index_arrays(tds, rng_t)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert perm_t.shape == (3, 4)
    for k in idx_j:
        np.testing.assert_array_equal(idx_t[k], idx_j[k])

    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    jidx = {k: jnp.asarray(v) for k, v in idx_j.items()}
    jbatch0 = jexp._batch(arrays, jidx, jnp.asarray(perm_j[0]))
    g0 = _sd(jax.grad(lambda p: jexp._loss(p, jbatch0)[0])(params), 2)
    jparams, _, jl, jlast = jexp.train_epoch(params, opt_state, arrays, jidx,
                                             perm_j)
    tl, tlast = texp.train_epoch(tds, idx_t, perm_t)
    assert_close(tl, jl, rtol=1e-5, atol=0)
    assert_close(tlast, jlast, rtol=1e-5, atol=0)

    want = _sd(jparams, 2)
    moved = 0
    for k, p in texp.model.state_dict().items():
        got, ref = p.numpy(), want[k].numpy()
        clear = np.abs(g0[k].numpy()) > 1e-6
        np.testing.assert_allclose(got[clear], ref[clear], rtol=0,
                                   atol=1e-3 * lr, err_msg=k)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3 * 2 * lr,
                                   err_msg=k)
        moved += int((np.abs(got - p0[k].numpy()) > 0.5 * lr).sum())
    assert moved > 100, "the parameters hardly moved"

    ve, vlast = jexp.eval_epoch(jparams, arrays, jidx, perm_j)
    te, tlast = texp.eval_epoch(tds, idx_t, perm_t)
    assert_close(te, ve, rtol=1e-4, atol=0)
    assert_close(tlast, vlast, rtol=1e-4, atol=0)


@pytest.mark.parametrize("path", ["single", "fleet", "dp2"])
def test_adam_l2_decays_parameters_without_gradient(tmp_path, path):
    """Three Adam-L2 steps of a two-layer EGNO, whose last node MLP feeds no
    loss term and so gets no gradient: as optax's chain(add_decayed_weights,
    adam) does, the port decays it (wd x p alone reaches Adam), on one
    process, in a seed fleet of K=2 (against JAX's SeedFleet) and through
    --dp 2 gloo ranks. Every parameter after the steps within rtol 1e-5 of
    JAX's, the unused MLP included, which moved by about lr a step. The
    weight decay is 1e-2, so that every gradient entry (wd x p included,
    the spectral weights' of order 1e-4) stands far above Adam's eps
    (1e-8), where fp32 rounding of the two sides could move an entry by up
    to lr (test_train_and_eval_epochs_match_jax's second tier); the atol,
    1e-3 x lr, covers entries that three steps of about lr bring near 0:
    each step moves a parameter by lr x m / sqrt(v), whose inputs agree
    within the gradients' 1e-4."""
    lr, wd, n_layers = 1e-3, 1e-2, 2
    model_kw = dict(n_layers=n_layers, hidden_nf=16, time_emb_dim=8)
    jds, tds = _split(tmp_path, s=12)
    jexp = JaxExperiment(JaxEGNO(**model_kw), lr=lr, weight_decay=wd)
    rng_j, rng_t = np.random.RandomState(9), np.random.RandomState(9)
    perm = make_perm(rng_t, len(tds), 4)
    np.testing.assert_array_equal(perm, jax_make_perm(rng_j, len(jds), 4))
    idx_t = EGNOExperiment(EGNO(**model_kw, device="cpu"), lr=lr,
                           weight_decay=wd).epoch_index_arrays(tds, rng_t)
    jidx = {k: jnp.asarray(v) for k, v in
            jexp.epoch_index_arrays(jds, rng_j).items()}
    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    unused = f"layers.{n_layers - 1}.node_net"
    convert = lambda p: egno_state_dict_from_jax_params(  # noqa: E731
        jax.tree.map(np.asarray, p), n_layers)

    if path == "fleet":
        from nonode_tpu.parallel import fleet as jfleet
        from nonode_tpu_torch.compat.params import \
            fleet_params_from_jax_params
        from nonode_tpu_torch.parallel.fleet import SeedFleet
        jf = jfleet.SeedFleet(jexp, [0, 1])
        params, jopt = jf.init()
        to_sd = lambda p: fleet_params_from_jax_params(  # noqa: E731
            lambda q: egno_state_dict_from_jax_params(q, n_layers),
            jax.tree.map(np.asarray, p))
        before = to_sd(params)       # the epoch donates the JAX buffers
        perms = np.stack([perm, perm[::-1]])
        jafter, _, _, _ = jf.train_epoch(params, jopt, arrays, jidx,
                                         jnp.asarray(perms))
        fleet = SeedFleet(EGNOExperiment(EGNO(**model_kw, device="cpu"),
                                         lr=lr, weight_decay=wd), [0, 1])
        after = {k: v.clone().requires_grad_() for k, v in before.items()}
        fleet.train_epoch(after, fleet.optimizer(after), tds, idx_t, perms)
        want = to_sd(jafter)
    else:
        params, opt_state = jexp.init(jax.random.PRNGKey(0))
        before = convert(params)     # the epoch donates the JAX buffers
        jafter, _, _, _ = jexp.train_epoch(params, opt_state, arrays, jidx,
                                           jnp.asarray(perm))
        want = convert(jafter)
        if path == "single":
            model = EGNO(**model_kw, device="cpu")
            model.load_state_dict(before, strict=True)
            EGNOExperiment(model, lr=lr, weight_decay=wd).train_epoch(
                tds, idx_t, perm)
            after = model.state_dict()
        else:
            from nonode_tpu_torch.parallel import mesh as meshes
            from torch_port_util import egno_epoch_on_rank
            split_kw = dict(data_dir=tmp_path, partition="train",
                            dataset="charged")
            after = meshes.launch(egno_epoch_on_rank, (
                {k: v.numpy() for k, v in before.items()}, model_kw,
                split_kw, idx_t, perm, lr, wd), 2, 1, torch.device("cpu"))
    assert set(after) == set(want)
    assert any(k.startswith(unused) for k in want)
    for k, ref in want.items():
        got = np.asarray(torch.as_tensor(after[k]).detach())
        assert_close(got, ref.numpy(), rtol=1e-5, atol=1e-3 * lr)
        if k.startswith(unused):
            moved = np.abs(got - before[k].detach().numpy()).max()
            assert moved > lr, (k, moved)


@pytest.mark.parametrize("dataset,varDT", [
    ("charged", False), ("charged", True), ("gravity", True)])
def test_multi_input_train_and_eval_epochs_match_jax(tmp_path, dataset,
                                                     varDT):
    """num_inputs=3: per-sample input offsets drawn from the same numpy
    stream, the time embeddings of the inputs, and the batch-global time
    correction of _batch, which is non-zero only for gravity varDT windows
    (pushed forward per sample). Three Adam-L2 steps and an eval epoch;
    losses rtol 1e-5 (train) and 1e-4 (eval), as the single-input test."""
    jds, tds = _split(tmp_path, dataset=dataset, num_inputs=3, varDT=varDT)
    jexp, params, opt_state, texp = _models(num_inputs=3, varDT=varDT)
    rng_j, rng_t = np.random.RandomState(6), np.random.RandomState(6)
    perm_j = jax_make_perm(rng_j, len(jds), 4)
    idx_j = jexp.epoch_index_arrays(jds, rng_j)
    perm_t = make_perm(rng_t, len(tds), 4)
    idx_t = texp.epoch_index_arrays(tds, rng_t)
    for k in idx_j:
        np.testing.assert_array_equal(idx_t[k], idx_j[k])
    last = idx_t["frames_in"][:, -1]
    corr = [last[b] - last[b].max() for b in perm_t]
    assert any(c.any() for c in corr) == (dataset == "gravity")

    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    jidx = {k: jnp.asarray(v) for k, v in idx_j.items()}
    jparams, _, jl, jlast = jexp.train_epoch(params, opt_state, arrays, jidx,
                                             perm_j)
    tl, tlast = texp.train_epoch(tds, idx_t, perm_t)
    assert_close(tl, jl, rtol=1e-5, atol=0)
    assert_close(tlast, jlast, rtol=1e-5, atol=0)
    ve, vlast = jexp.eval_epoch(jparams, arrays, jidx, perm_j)
    te, tlast = texp.eval_epoch(tds, idx_t, perm_t)
    assert_close(te, ve, rtol=1e-4, atol=0)
    assert_close(tlast, vlast, rtol=1e-4, atol=0)


def test_make_perm_matches_jax_and_drops_the_last_batch():
    for shuffle in (True, False):
        a = make_perm(np.random.RandomState(3), 23, 5, shuffle=shuffle)
        b = jax_make_perm(np.random.RandomState(3), 23, 5, shuffle=shuffle)
        assert a.shape == (4, 5)
        np.testing.assert_array_equal(a, b)


def test_early_stopping_patience_and_best_checkpoint(tmp_path):
    """The counterpart of tests/test_checkpoint_config.py's early-stopping
    tests: patience counts evaluations without improvement, an improvement
    resets it, and only an improvement overwrites the checkpoint."""
    quiet = dict(trace_func=lambda *a: None)
    m = torch.nn.Linear(2, 1)
    es = EarlyStopping(patience=2, path=tmp_path / "e.ckpt", **quiet)
    es(1.0, m)
    assert not es.early_stop and (tmp_path / "e.ckpt").exists()
    es(1.1, m)
    es(1.2, m)
    assert es.early_stop
    es2 = EarlyStopping(patience=2, path=tmp_path / "e2.ckpt", **quiet)
    for v in (1.0, 1.1, 0.9, 1.0):
        es2(v, m)
    assert not es2.early_stop and es2.counter == 1

    es3 = EarlyStopping(patience=5, path=tmp_path / "b.ckpt", **quiet)
    for val, fill in ((1.0, 0.0), (0.5, 1.0), (0.9, 9.0)):
        with torch.no_grad():
            m.weight.fill_(fill)
        es3(val, m)
    best = torch.nn.Linear(2, 1)
    load_params(tmp_path / "b.ckpt", best)
    assert torch.equal(best.weight, torch.ones(1, 2))
    assert es3.val_loss_min == 0.5
    es4 = EarlyStopping(patience=5, delta=0.2, path=tmp_path / "d.ckpt",
                        **quiet)
    es4(1.0, m)
    es4(0.9, m)                    # better, but by less than delta
    assert es4.counter == 1
