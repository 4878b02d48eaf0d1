"""Reference PyTorch checkpoints into the port's models, and back
(counterpart of nonode_tpu/compat/torch_port.py).

Users of the reference repository load their trained ``.pth`` state_dicts
here. The port keeps the reference's module names, so a checkpoint maps key
for key; these functions keep exactly the keys the JAX package reads
(EGNO: nonode_tpu/compat/torch_port.py:42-63; SEGNO: :97-116) and raise,
naming the key, where one is missing.

- EGNO: ``embedding``, ``layers.i.{edge_message_net.scalar_net.mlp,
  coord_net.mlp, node_v_net.mlp?, node_net.mlp?}.{0,2}``,
  ``time_conv_modules.i.t_conv.weights1`` and
  ``time_conv_x_modules.i.t_conv.weights1``.
- SEGNO: ``embedding``, ``module.{edge_mlp,node_mlp,coord_mlp}.{0,2}`` and
  ``enc_attn_net.attn_mlp.{0,2}`` with several inputs. The reference's
  ``module.coord_mlp_vel`` has no consumer in its forward and is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.egno import EGNO
from ..models.segno import SEGNO


def _get(sd, key):
    if key not in sd:
        raise KeyError(f"the reference state_dict has no {key!r}")
    v = sd[key]
    if torch.is_tensor(v):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _keepers(sd, out: dict):
    def linear(prefix):
        for name in ("weight", "bias"):
            out[f"{prefix}.{name}"] = _get(sd, f"{prefix}.{name}")

    def mlp(prefix):
        linear(f"{prefix}.0")
        linear(f"{prefix}.2")

    return linear, mlp


def egno_state_dict_from_reference(sd, n_layers: int,
                                   use_time_conv: bool = True) -> dict:
    """The reference EGNO state_dict ``sd`` -> a state_dict for the port's
    ``EGNO.load_state_dict(strict=True)``: the keys the JAX package's
    ``egno_params_from_state_dict`` reads, as float32 tensors; a node MLP
    the checkpoint lacks (``node_v_net`` without velocities) is left out,
    as there."""
    out = {}
    linear, mlp = _keepers(sd, out)
    linear("embedding")
    for i in range(n_layers):
        mlp(f"layers.{i}.edge_message_net.scalar_net.mlp")
        mlp(f"layers.{i}.coord_net.mlp")
        for name in ("node_v_net", "node_net"):
            if f"layers.{i}.{name}.mlp.0.weight" in sd:
                mlp(f"layers.{i}.{name}.mlp")
    if use_time_conv:
        for conv in ("time_conv_modules", "time_conv_x_modules"):
            for i in range(n_layers):
                key = f"{conv}.{i}.t_conv.weights1"
                out[key] = _get(sd, key)
    return out


def segno_state_dict_from_reference(sd) -> dict:
    """The reference SEGNO state_dict ``sd`` -> a state_dict for the port's
    ``SEGNO.load_state_dict(strict=True)``, without
    ``module.coord_mlp_vel``; the attention MLP where ``sd`` has one."""
    out = {}
    linear, mlp = _keepers(sd, out)
    linear("embedding")
    mlp("module.edge_mlp")
    mlp("module.node_mlp")
    mlp("module.coord_mlp")
    if "enc_attn_net.attn_mlp.0.weight" in sd:
        mlp("enc_attn_net.attn_mlp")
    return out


def load_reference_checkpoint(model, path, device):
    """Load the reference ``.pth`` state_dict at ``path`` into ``model`` (the
    port's EGNO or SEGNO) with every key checked; returns the model."""
    sd = torch.load(path, map_location=device, weights_only=True)
    if isinstance(model, EGNO):
        ours = egno_state_dict_from_reference(sd, model.n_layers,
                                              model.use_time_conv)
    elif isinstance(model, SEGNO):
        ours = segno_state_dict_from_reference(sd)
    else:
        raise TypeError(f"no reference layout for {type(model).__name__}; "
                        f"EGNO and SEGNO have one")
    model.load_state_dict(ours, strict=True)
    return model


def egno_state_dict_for_reference(model: EGNO) -> dict:
    """The port's EGNO as a reference-layout state_dict of numpy arrays
    (counterpart of nonode_tpu/compat/torch_port.py:66-94,
    ``egno_state_dict_from_params``), for the reference's own tooling."""
    return {k: v.detach().cpu().numpy()
            for k, v in egno_state_dict_from_reference(
                model.state_dict(), model.n_layers,
                model.use_time_conv).items()}
