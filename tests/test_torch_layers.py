"""nonode_tpu_torch layers against the JAX package: Linear/MLP, EGNNLayer on
both routes, and the spectral time ops.

Inputs come from numpy seeds; JAX weights come from ``.init(PRNGKey)`` and
are copied into the port's modules. Tolerances: 1e-5 where both sides run
the same fp32 arithmetic in another order; 2e-5 for the spectral ops, whose
FFTs (pocketfft in JAX, torch's own on the CPU) round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.nn import MLP as JaxMLP
from nonode_tpu.ops import spectral as jspec
from nonode_tpu.ops.dense_graph import EGNNLayer as JaxEGNNLayer
from nonode_tpu_torch.nn import MLP, Linear
from nonode_tpu_torch.ops import spectral as tspec
from nonode_tpu_torch.ops.dense_graph import (EGNNLayer, masked_mean_j,
                                              offdiag_mask)
from torch_port_util import assert_close, egnn_layer_sd, mlp_sd, t

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("last_act,flat", [(False, False), (True, False),
                                           (False, True)])
def test_mlp_and_from_preact_match_jax(last_act, flat):
    jm = JaxMLP(6, 8, 3, last_act=last_act, flat=flat)
    p = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    m = MLP(6, 8, 3, last_act=last_act, flat=flat, device="cpu")
    m.load_state_dict(mlp_sd("mlp", p), strict=True)
    with torch.no_grad():
        assert_close(m(t(x)), jm(p, jnp.asarray(x)), **TOL)
        pre = m.mlp[0](t(x))
        assert_close(m.from_preact(pre), jm(p, jnp.asarray(x)), **TOL)


def test_linear_init_bounds_are_torch_defaults():
    g = torch.Generator().manual_seed(0)
    lin = Linear(100, 50, generator=g)
    assert lin.weight.shape == (50, 100) and lin.bias.shape == (50,)
    assert float(lin.weight.detach().abs().max()) <= 0.1
    assert float(lin.bias.detach().abs().max()) <= 0.1
    assert float(lin.weight.detach().abs().max()) > 0.09          # fills the range
    again = Linear(100, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(lin.weight, again.weight)         # seeded


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_v,edge_mask", [(False, None), (True, None),
                                              (True, "2d"), (True, "batched")])
def test_egnn_layer_matches_jax(with_v, edge_mask, fused):
    n, h, e = 5, 16, 2
    jl = JaxEGNNLayer(h, e, with_v=with_v)
    params = jl.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, n, 3).astype(np.float32)
    hh = rng.randn(2, 3, n, h).astype(np.float32)
    v = rng.randn(2, 3, n, 3).astype(np.float32)
    efea = rng.randn(3, n, n, e).astype(np.float32)     # broadcast over dim 0
    em = None
    if edge_mask == "2d":
        em = (rng.rand(n, n) < 0.5).astype(np.float32)
    elif edge_mask == "batched":
        em = (rng.rand(2, 3, n, n) < 0.5).astype(np.float32)
    jx, jv, jh = jl(params, jnp.asarray(x), jnp.asarray(hh), jnp.asarray(efea),
                    v=jnp.asarray(v) if with_v else None,
                    edge_mask=None if em is None else jnp.asarray(em))
    layer = EGNNLayer(h, e, with_v=with_v, fused=fused, device="cpu")
    layer.load_state_dict(egnn_layer_sd(params), strict=True)
    with torch.no_grad():
        tx, _, th = layer(t(x), t(hh), t(efea), v=t(v) if with_v else None,
                          edge_mask=None if em is None else t(em))
    assert_close(tx, jx, **TOL)
    assert_close(th, jh, **TOL)


def test_post_mean_clip_engages():
    n, h, e = 4, 16, 2
    jl = JaxEGNNLayer(h, e)
    params = jl.init(jax.random.PRNGKey(0))
    params["coord_net"]["l2"]["w"] = params["coord_net"]["l2"]["w"] * 1e4
    rng = np.random.RandomState(1)
    x = rng.randn(8, n, 3).astype(np.float32)
    hh = rng.randn(8, n, h).astype(np.float32)
    efea = rng.randn(8, n, n, e).astype(np.float32)
    jx, _, jh = jl(params, jnp.asarray(x), jnp.asarray(hh), jnp.asarray(efea))
    assert np.abs(np.asarray(jx) - x).max() >= 100.0 - 1e-3
    layer = EGNNLayer(h, e, device="cpu")
    layer.load_state_dict(egnn_layer_sd(params), strict=True)
    with torch.no_grad():
        tx, _, th = layer(t(x), t(hh), t(efea))
    assert_close(tx, jx, rtol=1e-5, atol=1e-4)
    assert_close(th, jh, **TOL)


def test_masked_mean_degree_clamp():
    mask = offdiag_mask(3) * torch.tensor([[1., 1, 1], [0, 0, 0], [1, 1, 1]])
    m = torch.ones(3, 3, 2)
    out = masked_mean_j(m, mask)
    assert torch.equal(out[1], torch.zeros(2))           # degree 0 -> 1
    assert torch.equal(out[0], torch.ones(2))


@pytest.mark.parametrize("t_steps,modes", [(10, 2), (5, 3), (8, 4), (2, 2),
                                           (4, 3)])
def test_spectral_ops_match_jax(t_steps, modes):
    rng = np.random.RandomState(t_steps)
    ch = 6
    x = rng.randn(t_steps, 3, 4, ch).astype(np.float32)
    conv = jspec.SpectralConv(ch, ch, modes)
    p = conv.init(jax.random.PRNGKey(0))
    tc = tspec.SpectralConv(ch, ch, modes, device="cpu")
    tc.load_state_dict({"weights1": t(p["w"])}, strict=True)
    with torch.no_grad():
        assert_close(tc(t(x)), conv(p, jnp.asarray(x)), **SPEC_TOL)

    jt = jspec.TimeConv(ch, modes)
    pt = jt.init(jax.random.PRNGKey(1))
    tt = tspec.TimeConv(ch, modes, device="cpu")
    tt.load_state_dict({"t_conv.weights1": t(pt["t_conv"]["w"])}, strict=True)
    with torch.no_grad():
        assert_close(tt(t(x)), jt(pt, jnp.asarray(x)), **SPEC_TOL)

    xs = rng.randn(t_steps, 3, 4, 3, 2).astype(np.float32)
    jx = jspec.TimeConvX(2, modes)
    px = jx.init(jax.random.PRNGKey(2))
    tx = tspec.TimeConvX(2, modes, device="cpu")
    tx.load_state_dict({"t_conv.weights1": t(px["t_conv"]["w"])}, strict=True)
    with torch.no_grad():
        assert_close(tx(t(xs)), jx(px, jnp.asarray(xs)), **SPEC_TOL)

    steps = rng.randint(-5, 20, size=(3, t_steps)).astype(np.float32)
    for dim in (32, 7):
        assert_close(tspec.timestep_embedding(t(steps), dim),
                     jspec.timestep_embedding(jnp.asarray(steps), dim), **TOL)
