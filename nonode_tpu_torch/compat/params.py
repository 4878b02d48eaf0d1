"""Weights across frameworks: the nonode_tpu EGNO and SEGNO parameter trees
(as numpy arrays) to this package's ``state_dict``s.

The port's own copy of the layout mappings in
nonode_tpu/compat/torch_port.py:66-116 (``egno_state_dict_from_params``,
``segno_params_from_state_dict``): both frameworks keep Linear weights as
``[out, in]``, so tensors map one to one onto the reference names.
"""

from __future__ import annotations

import numpy as np
import torch


def _putters(out: dict):
    """put_linear(prefix, {w, b?}) and put_mlp(prefix, {l1, l2}), writing
    into ``out`` under the reference names (``prefix.0`` / ``prefix.2``)."""
    def put_linear(prefix, p):
        out[f"{prefix}.weight"] = p["w"]
        if "b" in p:
            out[f"{prefix}.bias"] = p["b"]

    def put_mlp(prefix, p):
        put_linear(f"{prefix}.0", p["l1"])
        put_linear(f"{prefix}.2", p["l2"])

    return put_linear, put_mlp


def _tensors(out: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def egno_state_dict_from_jax_params(params_np, n_layers: int) -> dict:
    """``params_np``: the JAX EGNO tree ({embedding, layers[i]{edge_net,
    coord_net, node_v_net?, node_net?}, time_conv[i], time_conv_x[i]}) with
    numpy leaves. Returns a state_dict for ``EGNO.load_state_dict(strict=True)``."""
    out = {}
    put_linear, put_mlp = _putters(out)
    put_linear("embedding", params_np["embedding"])
    if len(params_np["layers"]) != n_layers:
        raise ValueError(f"tree has {len(params_np['layers'])} layers, "
                         f"expected {n_layers}")
    for i, lp in enumerate(params_np["layers"]):
        put_mlp(f"layers.{i}.edge_message_net.scalar_net.mlp", lp["edge_net"])
        put_mlp(f"layers.{i}.coord_net.mlp", lp["coord_net"])
        if "node_v_net" in lp:
            put_mlp(f"layers.{i}.node_v_net.mlp", lp["node_v_net"])
        if "node_net" in lp:
            put_mlp(f"layers.{i}.node_net.mlp", lp["node_net"])
    if "time_conv" in params_np:
        for i in range(n_layers):
            out[f"time_conv_modules.{i}.t_conv.weights1"] = \
                params_np["time_conv"][i]["t_conv"]["w"]
            out[f"time_conv_x_modules.{i}.t_conv.weights1"] = \
                params_np["time_conv_x"][i]["t_conv"]["w"]
    return _tensors(out)


def segno_state_dict_from_jax_params(params_np) -> dict:
    """``params_np``: the JAX SEGNO tree ({embedding, gcl{edge_mlp, node_mlp,
    coord_mlp_l1, coord_mlp_l2}, attn?{l1, l2}}) with numpy leaves. Returns
    a state_dict for ``SEGNO.load_state_dict(strict=True)``: the GCL under
    ``module``, the attention under ``enc_attn_net.attn_mlp``."""
    out = {}
    put_linear, put_mlp = _putters(out)
    put_linear("embedding", params_np["embedding"])
    gcl = params_np["gcl"]
    put_mlp("module.edge_mlp", gcl["edge_mlp"])
    put_mlp("module.node_mlp", gcl["node_mlp"])
    put_mlp("module.coord_mlp", {"l1": gcl["coord_mlp_l1"],
                                 "l2": gcl["coord_mlp_l2"]})
    if "attn" in params_np:
        put_mlp("enc_attn_net.attn_mlp", params_np["attn"])
    return _tensors(out)


def _seed_slice(tree, i):
    """Seed ``i`` of a tree of numpy leaves with a leading K axis."""
    if isinstance(tree, dict):
        return {k: _seed_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_seed_slice(v, i) for v in tree)
    return np.asarray(tree)[i]


def fleet_params_from_jax_params(convert, params_np) -> dict:
    """A nonode_tpu seed-fleet tree (numpy leaves with a leading K axis, as
    ``SeedFleet.init`` makes it) -> the port's fleet parameters, a
    ``state_dict``-named dict of [K, ...] tensors. ``convert`` maps one
    seed's tree (``egno_state_dict_from_jax_params`` with its ``n_layers``
    bound, or ``segno_state_dict_from_jax_params``)."""
    first = params_np
    while isinstance(first, (dict, list, tuple)):
        first = next(iter(first.values())) if isinstance(first, dict) \
            else first[0]
    per_seed = [convert(_seed_slice(params_np, i))
                for i in range(np.asarray(first).shape[0])]
    return {name: torch.stack([sd[name] for sd in per_seed])
            for name in per_seed[0]}
