"""nonode_tpu_torch EGNO forward and weight carrier against the JAX package.

JAX EGNO weights (``.init(PRNGKey)``) reach the port through
compat.params.egno_state_dict_from_jax_params. Tolerance 5e-5 (rtol and
atol): the same fp32 arithmetic in another order, through up to four layers
and their FFTs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from nonode_tpu.compat.torch_port import egno_state_dict_from_params
from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.train.loop import prepare_inputs as jax_prepare_inputs
from nonode_tpu_torch.compat.params import egno_state_dict_from_jax_params
from nonode_tpu_torch.models.egno import (EGNO, effective_num_modes,
                                          input_slot_map)
from nonode_tpu_torch.train.loop import prepare_inputs
from torch_port_util import assert_close, t

TOL = dict(rtol=5e-5, atol=5e-5)


def _port(jmodel, params, **kw):
    model = EGNO(n_layers=jmodel.n_layers, in_node_nf=jmodel.in_node_nf,
                 in_edge_nf=jmodel.in_edge_nf, hidden_nf=jmodel.hidden_nf,
                 num_modes=jmodel.num_modes,
                 num_timesteps=jmodel.num_timesteps,
                 time_emb_dim=jmodel.time_emb_dim,
                 num_inputs=jmodel.num_inputs, device="cpu", **kw)
    sd = egno_state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                         jmodel.n_layers)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _inputs(lead, n, seed):
    rng = np.random.RandomState(seed)
    loc = rng.randn(*lead, n, 3).astype(np.float32)
    vel = rng.randn(*lead, n, 3).astype(np.float32)
    b = lead[-1]
    charges = rng.choice([-1.0, 1.0], (b, n, 1)).astype(np.float32)
    w = np.einsum("bik,bjk->bij", charges, charges)[..., None]
    return loc, vel, charges, w


def test_slot_map_and_mode_clamp():
    assert input_slot_map(3, 10) == [0, 0, 0, 1, 1, 1, 2, 2, 2, 2]
    assert input_slot_map(1, 4) == [0, 0, 0, 0]
    assert effective_num_modes(10, 2) == 2
    assert effective_num_modes(5, 4) == 3          # the T == 5 clamp
    assert effective_num_modes(4, 6) == 4


@pytest.mark.parametrize("fused", [True, False])
def test_single_input_forward_matches_jax(fused):
    jm = JaxEGNO(n_layers=2, hidden_nf=16, time_emb_dim=8, num_timesteps=10)
    params = jm.init(jax.random.PRNGKey(0))
    loc, vel, charges, w = _inputs((3,), 5, seed=1)
    nodes, edge_attr, loc_mean = jax_prepare_inputs(
        *map(jnp.asarray, (loc, vel, w, charges)))
    t_out = np.tile(np.arange(3, 13, dtype=np.float32), (3, 1))
    jx, jv, jh = jax.jit(jm.__call__)(params, jnp.asarray(loc),
                                      jnp.asarray(vel), nodes, edge_attr,
                                      loc_mean, timesteps_out=jnp.asarray(t_out))
    model = _port(jm, params, fused=fused)
    with torch.no_grad():
        tn, te, tmean = prepare_inputs(*map(t, (loc, vel, w, charges)))
        assert_close(te, edge_attr, **TOL)
        tx, tv, th = model(t(loc), t(vel), tn, te, tmean,
                           timesteps_out=t(t_out))
    assert tx.shape == (10, 3, 5, 3)
    for a, b in ((tx, jx), (tv, jv), (th, jh)):
        assert_close(a, b, **TOL)


def test_multi_input_forward_matches_jax():
    jm = JaxEGNO(n_layers=2, hidden_nf=16, time_emb_dim=8, num_inputs=3,
                 num_timesteps=10)
    params = jm.init(jax.random.PRNGKey(3))
    loc, vel, charges, w = _inputs((3, 2), 5, seed=4)    # [L, B, N, 3]
    nodes, edge_attr, loc_mean = jax_prepare_inputs(
        *map(jnp.asarray, (loc, vel, w[None], charges[None])))
    t_in = np.array([[-4.0, -2.0, 0.0], [-2.0, -1.0, 0.0]], np.float32)
    t_out = np.tile(np.arange(1, 11, dtype=np.float32), (2, 1))
    jx, jv, jh = jax.jit(jm.__call__)(
        params, jnp.asarray(loc), jnp.asarray(vel), nodes, edge_attr,
        loc_mean, timesteps_out=jnp.asarray(t_out),
        timesteps_in=jnp.asarray(t_in))
    model = _port(jm, params)
    with torch.no_grad():
        tn, te, tmean = prepare_inputs(t(loc), t(vel), t(w)[None],
                                       t(charges)[None])
        tx, tv, th = model(t(loc), t(vel), tn, te, tmean,
                           timesteps_out=t(t_out), timesteps_in=t(t_in))
    for a, b in ((tx, jx), (tv, jv), (th, jh)):
        assert_close(a, b, **TOL)


def test_canonical_width_matches_jax():
    """The flagship EGNO (4 layers, hidden 64, T=10) at B=4, built as
    __graft_entry__._egno_example builds it."""
    jm, params, (loc, vel, nodes, edge_attr, loc_mean) = \
        __graft_entry__._egno_example(b=4)
    jx, jv, jh = jax.jit(jm.__call__)(params, loc, vel, nodes, edge_attr,
                                      loc_mean)
    model = _port(jm, params)
    assert any(layer._use_fused(t(loc), None) for layer in model.layers)
    with torch.no_grad():
        tx, tv, th = model(*map(t, (loc, vel, nodes, edge_attr, loc_mean)))
    for a, b in ((tx, jx), (tv, jv), (th, jh)):
        assert_close(a, b, **TOL)


def test_weight_carrier_matches_reference_export():
    jm = JaxEGNO(n_layers=3, hidden_nf=16, time_emb_dim=8)
    params = jm.init(jax.random.PRNGKey(5))
    ours = egno_state_dict_from_jax_params(jax.tree.map(np.asarray, params), 3)
    ref = egno_state_dict_from_params(params, 3)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v)
    model = EGNO(n_layers=3, hidden_nf=16, time_emb_dim=8, device="cpu")
    assert set(model.state_dict()) == set(ours)
    model.load_state_dict(ours, strict=True)
    with pytest.raises(ValueError, match="layers"):
        egno_state_dict_from_jax_params(jax.tree.map(np.asarray, params), 4)


def test_seeded_init_is_reproducible():
    a = EGNO(n_layers=1, hidden_nf=16, device="cpu",
             generator=torch.Generator().manual_seed(7))
    b = EGNO(n_layers=1, hidden_nf=16, device="cpu",
             generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
