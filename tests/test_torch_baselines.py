"""The port's baseline model zoo (nonode_tpu_torch/models/baselines.py) and
reference-checkpoint loading (nonode_tpu_torch/compat/torch_port.py)
against the JAX package.

Inputs come from numpy seeds; JAX weights come from ``.init(PRNGKey)`` and
reach the port through compat.params.baseline_state_dict_from_jax_params.
Tolerances, set before the first run: a forward within 1e-5 x max(1,
max|ref|) (fp32 in another order through at most three layers), every
parameter's gradient of a sum-of-squares loss within 1e-4 x max(1,
max|ref|) of jax.grad, the rotation properties of tests/test_baselines.py
at its rtol 1e-4 / atol 1e-5, and a reference checkpoint's EGNO and SEGNO
forwards within 5e-5 (tests/test_torch_egno.py's and test_torch_segno.py's
model tolerance).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.compat.torch_port import (egno_params_from_state_dict,
                                          egno_state_dict_from_params,
                                          segno_params_from_state_dict)
from nonode_tpu.models import baselines as jb
from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.models.segno import SEGNO as JaxSEGNO
from nonode_tpu.train.loop import prepare_inputs as jax_prepare_inputs
from nonode_tpu_torch import models as tm
from nonode_tpu_torch.compat import torch_port
from nonode_tpu_torch.compat.params import (
    baseline_state_dict_from_jax_params, egno_state_dict_from_jax_params)
from nonode_tpu_torch.train.loop import prepare_inputs
from tests.test_ops import rand_rotation
from torch_port_util import assert_close, t

REPO = Path(__file__).resolve().parents[1]
FWD_RTOL, GRAD_RTOL = 1e-5, 1e-4
MODEL_TOL = dict(rtol=5e-5, atol=5e-5)


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _case(kind, seed=0):
    """(JAX model, the port's keyword arguments, the inputs as a tuple of
    numpy arrays or lists of them)."""
    rng = np.random.RandomState(seed)
    if kind == "GNN":
        kw = dict(n_layers=2, in_node_nf=3, in_edge_nf=2, hidden_nf=16)
        return jb.GNN(**kw), kw, (_f(rng, 2, 5, 3), _f(rng, 2, 5, 5, 2))
    if kind == "LinearDynamics":
        return jb.LinearDynamics(), {}, (_f(rng, 3, 5, 3), _f(rng, 3, 5, 3))
    if kind.startswith("RFVel"):
        kw = dict(hidden_nf=16, edge_attr_nf=1,
                  n_layers=1 if kind == "RFVel-1" else 2)
        x, v = _f(rng, 2, 4, 3), _f(rng, 2, 4, 3)
        vn = np.linalg.norm(v, axis=-1, keepdims=True)
        return jb.RFVel(**kw), kw, (vn, x, v, _f(rng, 2, 4, 4, 1))
    if kind == "EquivariantScalarNet":
        kw = dict(n_vector_input=2, hidden_dim=16, n_scalar_input=3)
        return (jb.EquivariantScalarNet(**kw), kw,
                ([_f(rng, 6, 3), _f(rng, 6, 3)], _f(rng, 6, 3)))
    if kind == "EGMN":
        kw = dict(n_layers=3, n_vector_input=2, hidden_dim=8,
                  n_scalar_input=4)
        return jb.EGMN(**kw), kw, ([_f(rng, 5, 3), _f(rng, 5, 3)],
                                   _f(rng, 5, 4))
    assert kind == "FullMLP"
    kw = dict(in_node_nf=6, hidden_nf=16, n_layers=2)
    return jb.FullMLP(**kw), kw, (_f(rng, 3, 5, 6),)


def _jax_in(a):
    return [jnp.asarray(v) for v in a] if isinstance(a, list) \
        else jnp.asarray(a)


def _torch_in(a):
    return [t(v) for v in a] if isinstance(a, list) else t(a)


def _outs(y):
    return y if isinstance(y, tuple) else (y,)


def _port(kind, kw, params):
    cls = getattr(tm, kind.split("-")[0])
    model = cls(**kw, device="cpu")
    model.load_state_dict(baseline_state_dict_from_jax_params(
        kind.split("-")[0], jax.tree.map(np.asarray, params)), strict=True)
    return model


def _within(got, ref, rel):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    got, ref = got[~nan], ref[~nan]
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


KINDS = ["GNN", "LinearDynamics", "RFVel-1", "RFVel", "EquivariantScalarNet",
         "EGMN", "FullMLP"]


@pytest.mark.parametrize("kind", KINDS)
def test_baseline_forward_and_gradients_match_jax(kind):
    """The forward, and the gradient of every parameter of sum(y^2) over
    the outputs. RFVel at two layers: the gradients of its first layer are
    NaN in both (the dense radial's sqrt at the diagonal, models/
    baselines.py), at the same entries; its last layer's are finite."""
    jm, kw, inputs = _case(kind)
    params = jm.init(jax.random.PRNGKey(1))
    key = kind.split("-")[0]

    def jloss(p):
        return sum((y ** 2).sum() for y in _outs(jm(p, *map(_jax_in,
                                                           inputs))))

    jouts = _outs(jm(params, *map(_jax_in, inputs)))
    jgrads = baseline_state_dict_from_jax_params(
        key, jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    model = _port(kind, kw, params)
    outs = _outs(model(*map(_torch_in, inputs)))
    assert len(outs) == len(jouts)
    for a, b in zip(outs, jouts):
        _within(a, b, FWD_RTOL)
    sum((y ** 2).sum() for y in outs).backward()
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        assert p.grad is not None, name
        _within(p.grad, jgrads[name].numpy(), GRAD_RTOL)
    if kind == "RFVel":
        assert torch.isnan(named["layers.0.phi_l1.weight"].grad).any()
        assert all(torch.isfinite(p.grad).all() for n, p in named.items()
                   if n.startswith("layers.1."))


def test_rfvel_init_follows_jax():
    """RFVel's phi_l2 is xavier_uniform(gain=0.001) without a bias, the
    other Linears torch's default bounds."""
    model = tm.RFVel(hidden_nf=64, n_layers=4, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    bound = 0.001 * np.sqrt(6.0 / 65)
    for layer in model.layers:
        assert layer.phi_l2.bias is None
        w = layer.phi_l2.weight
        w = w.detach()
        assert w.shape == (1, 64) and float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.5 * bound
        assert float(layer.phi_l1.weight.detach().abs().max()) <= 1.0
    names = set(dict(model.named_parameters()))
    assert "layers.3.phi_l2.weight" in names
    assert "layers.0.vel_mlp.mlp.0.weight" in names


def test_rfvel_rotation_equivariance():
    m = tm.RFVel(hidden_nf=16, edge_attr_nf=1, n_layers=2, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    x, v = _f(rng, 4, 3), _f(rng, 4, 3)
    vn = np.linalg.norm(v, axis=-1, keepdims=True)
    e = _f(rng, 4, 4, 1)
    r = rand_rotation(5).astype(np.float32)
    with torch.no_grad():
        x1 = m(t(vn), t(x), t(v), t(e)).numpy()
        x2 = m(t(vn), t(x @ r), t(v @ r), t(e)).numpy()
    np.testing.assert_allclose(x2, x1 @ r, rtol=1e-4, atol=1e-5)


def test_equivariant_scalar_net_rotation_equivariance():
    m = tm.EquivariantScalarNet(n_vector_input=2, hidden_dim=16,
                                n_scalar_input=3, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    v1, v2, s = _f(rng, 6, 3), _f(rng, 6, 3), _f(rng, 6, 3)
    r = rand_rotation(2).astype(np.float32)
    with torch.no_grad():
        vec1, sc1 = m([t(v1), t(v2)], t(s))
        vec2, sc2 = m([t(v1 @ r), t(v2 @ r)], t(s))
    np.testing.assert_allclose(vec2.numpy(), vec1.numpy() @ r, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sc2.numpy(), sc1.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_egmn_growing_basis_and_rotation_equivariance():
    m = tm.EGMN(n_layers=3, n_vector_input=2, hidden_dim=8, n_scalar_input=4,
                device="cpu", generator=torch.Generator().manual_seed(0))
    assert [layer.in_scalar.mlp[0].weight.shape[1] for layer in m.layers] \
        == [2 ** 2 + 4, 3 ** 2 + 8, 4 ** 2 + 8]
    rng = np.random.RandomState(1)
    v1, v2, s = _f(rng, 5, 3), _f(rng, 5, 3), _f(rng, 5, 4)
    r = rand_rotation(3).astype(np.float32)
    with torch.no_grad():
        vec, sc = m([t(v1), t(v2)], t(s))
        vec_r, sc_r = m([t(v1 @ r), t(v2 @ r)], t(s))
    assert vec.shape == (5, 3) and sc.shape == (5, 8)
    np.testing.assert_allclose(vec_r.numpy(), vec.numpy() @ r, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sc_r.numpy(), sc.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_baseline_converter_refuses_other_trees():
    params = jax.tree.map(np.asarray, jb.GNN(2, 3, 2, 8).init(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="unknown baseline"):
        baseline_state_dict_from_jax_params("EGNN", params)
    with pytest.raises(ValueError, match="keys"):
        baseline_state_dict_from_jax_params("FullMLP", params)
    sd = baseline_state_dict_from_jax_params("GNN", params)
    with pytest.raises(RuntimeError, match="edge.2"):
        tm.GNN(3, 3, 2, 8, device="cpu").load_state_dict(sd, strict=True)


# ---- reference checkpoints ----

def _egno_inputs(seed):
    rng = np.random.RandomState(seed)
    loc, vel = _f(rng, 3, 5, 3), _f(rng, 3, 5, 3)
    charges = rng.choice([-1.0, 1.0], (3, 5, 1)).astype(np.float32)
    w = np.einsum("bik,bjk->bij", charges, charges)[..., None]
    return loc, vel, charges, w


@pytest.mark.parametrize("with_v", [True, False])
def test_reference_egno_checkpoint_loads_as_jax_loads_it(tmp_path, with_v):
    """A reference-layout EGNO .pth (with and without node_v_net), written
    by torch.save, through JAX's egno_params_from_state_dict and the port's
    load_reference_checkpoint: the port holds the checkpoint's tensors, the
    tree JAX loaded exports to the same state_dict bit for bit, and with
    node_v_net the two forwards agree within 5e-5. Without it neither
    package's EGNO forward runs (both pass v to every layer), so the
    weights are what is compared."""
    kw = dict(n_layers=2, hidden_nf=16, time_emb_dim=8, num_timesteps=10,
              with_v=with_v)
    sd = tm.EGNO(**kw, device="cpu",
                 generator=torch.Generator().manual_seed(3)).state_dict()
    assert any("node_v_net" in k for k in sd) == with_v
    path = tmp_path / "egno.pth"
    torch.save(sd, path)
    params = egno_params_from_state_dict(torch.load(path), n_layers=2)
    model = torch_port.load_reference_checkpoint(
        tm.EGNO(**kw, device="cpu"), path, "cpu")
    exported = egno_state_dict_from_params(params, 2)
    assert set(exported) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert torch.equal(p, sd[name]), name
        np.testing.assert_array_equal(p.numpy(), exported[name])
    if not with_v:
        return
    loc, vel, charges, w = _egno_inputs(1)
    nodes, edge_attr, loc_mean = jax_prepare_inputs(
        *map(jnp.asarray, (loc, vel, w, charges)))
    want = JaxEGNO(**kw)(params, jnp.asarray(loc), jnp.asarray(vel), nodes,
                         edge_attr, loc_mean)
    with torch.no_grad():
        got = model(t(loc), t(vel), *prepare_inputs(
            *map(t, (loc, vel, w, charges))))
    for a, b in zip(got, want):
        assert_close(a, b, **MODEL_TOL)


@pytest.mark.parametrize("agg", [None, "attn"], ids=["single", "attn"])
def test_reference_segno_checkpoint_loads_as_jax_loads_it(tmp_path, agg):
    """A reference-layout SEGNO .pth with module.coord_mlp_vel (which both
    drop) and, with several inputs, the attention MLP: the two loaders'
    forwards within 5e-5."""
    gen = torch.Generator().manual_seed(4)
    sd = tm.SEGNO(hidden_nf=16, multiple_agg=agg, device="cpu",
                  generator=gen).state_dict()
    sd["module.coord_mlp_vel.0.weight"] = torch.randn(16, 16, generator=gen)
    sd["module.coord_mlp_vel.0.bias"] = torch.randn(16, generator=gen)
    sd["module.coord_mlp_vel.2.weight"] = torch.randn(1, 16, generator=gen)
    path = tmp_path / "segno.pth"
    torch.save(sd, path)
    jm = JaxSEGNO(hidden_nf=16, multiple_agg=agg)
    params = segno_params_from_state_dict(torch.load(path))
    model = torch_port.load_reference_checkpoint(
        tm.SEGNO(hidden_nf=16, multiple_agg=agg, device="cpu"), path, "cpu")
    assert not any("coord_mlp_vel" in k for k in model.state_dict())
    rng = np.random.RandomState(5)
    lead = (3,) if agg is None else (3, 3)
    x, v = _f(rng, *lead, 5, 3), _f(rng, *lead, 5, 3)
    his = np.sqrt((v ** 2).sum(-1, keepdims=True))
    ea = _f(rng, 3, 5, 5, 2)
    in_steps = None if agg is None else (0, 2, 5)
    want = jm(params, *map(jnp.asarray, (his, x, v, ea)), T=10,
              in_steps=in_steps)
    with torch.no_grad():
        got = model(*map(t, (his, x, v, ea)), T=10, in_steps=in_steps)
    for a, b in zip(got, want):
        assert_close(a, b, **MODEL_TOL)


@pytest.mark.parametrize("model,missing", [
    ("egno", "layers.1.coord_net.mlp.2.bias"),
    ("egno", "time_conv_x_modules.0.t_conv.weights1"),
    ("segno", "module.node_mlp.0.weight")])
def test_reference_checkpoint_missing_a_key_raises_naming_it(model, missing):
    if model == "egno":
        sd = tm.EGNO(n_layers=2, hidden_nf=8, device="cpu").state_dict()
        convert = lambda d: torch_port.egno_state_dict_from_reference(d, 2)  # noqa: E731
    else:
        sd = tm.SEGNO(hidden_nf=8, device="cpu").state_dict()
        convert = torch_port.segno_state_dict_from_reference
    assert set(convert(sd)) == set(sd)
    del sd[missing]
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        convert(sd)


def test_egno_export_equals_jax_export_bitwise():
    """egno_state_dict_for_reference of the port's EGNO holding JAX's
    weights is JAX's egno_state_dict_from_params, key for key and bit for
    bit."""
    jm = JaxEGNO(n_layers=3, hidden_nf=16, time_emb_dim=8)
    params = jm.init(jax.random.PRNGKey(2))
    model = tm.EGNO(n_layers=3, hidden_nf=16, time_emb_dim=8, device="cpu")
    model.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), 3), strict=True)
    got = torch_port.egno_state_dict_for_reference(model)
    want = egno_state_dict_from_params(params, 3)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_presets_are_the_jax_packages_bytes():
    ours = sorted(p.name for p in
                  (REPO / "nonode_tpu_torch" / "configs").glob("*.json"))
    theirs = sorted(p.name for p in
                    (REPO / "nonode_tpu" / "configs").glob("*.json"))
    assert ours == theirs
    for name in ours:
        assert (REPO / "nonode_tpu_torch" / "configs" / name).read_bytes() \
            == (REPO / "nonode_tpu" / "configs" / name).read_bytes(), name
