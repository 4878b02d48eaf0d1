"""Helpers shared by the tests of nonode_tpu_torch: numpy arrays and JAX
parameter trees into the port's tensors and state_dict names."""

import numpy as np
import torch


def t(a):
    """A numpy (or JAX) array as a float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def mlp_sd(prefix, p):
    out = {}
    for k, name in (("l1", "0"), ("l2", "2")):
        out[f"{prefix}.{name}.weight"] = t(p[k]["w"])
        out[f"{prefix}.{name}.bias"] = t(p[k]["b"])
    return out


def egnn_layer_sd(lp):
    """A JAX EGNNLayer parameter tree as the port's EGNNLayer state_dict."""
    sd = {}
    sd.update(mlp_sd("edge_message_net.scalar_net.mlp", lp["edge_net"]))
    sd.update(mlp_sd("coord_net.mlp", lp["coord_net"]))
    for name in ("node_v_net", "node_net"):
        if name in lp:
            sd.update(mlp_sd(f"{name}.mlp", lp[name]))
    return sd


def assert_close(actual, expected, rtol, atol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol)
