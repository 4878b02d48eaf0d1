"""Weights across frameworks: the nonode_tpu EGNO parameter tree (as numpy
arrays) to this package's EGNO ``state_dict``.

The port's own copy of the layout mapping in
nonode_tpu/compat/torch_port.py:66-97 (``egno_state_dict_from_params``):
both frameworks keep Linear weights as ``[out, in]``, so tensors map one to
one onto the reference names.
"""

from __future__ import annotations

import numpy as np
import torch


def egno_state_dict_from_jax_params(params_np, n_layers: int) -> dict:
    """``params_np``: the JAX EGNO tree ({embedding, layers[i]{edge_net,
    coord_net, node_v_net?, node_net?}, time_conv[i], time_conv_x[i]}) with
    numpy leaves. Returns a state_dict for ``EGNO.load_state_dict(strict=True)``."""
    out = {}

    def put_linear(prefix, p):
        out[f"{prefix}.weight"] = p["w"]
        if "b" in p:
            out[f"{prefix}.bias"] = p["b"]

    def put_mlp(prefix, p):
        put_linear(f"{prefix}.0", p["l1"])
        put_linear(f"{prefix}.2", p["l2"])

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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
