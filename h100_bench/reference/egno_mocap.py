"""EGNO on CMU motion capture in plain PyTorch, float32: the model of
``egno.py`` on one skeleton graph of N joints, decoding the T frames that
end ``delta_frame`` after the input frame (EGNO/model/egno.py, with the
inputs of EGNO/motion/dataset.py and the loss of EGNO's mocap training).

A sample is the input frame's positions x0 and velocities v0 [B, N, 3];
its target the T frames [B, T, N, 3]. The graph is given, never built
here: the edge mask [N, N] (1 on the skeleton's and the 2-hop edges) and
the edge attributes [N, N, 1] (1 on a skeleton edge, 2 on a 2-hop one, 0
elsewhere) come from the caller. The node feature is z / 10, the
positions' second coordinate (dataset.py:156), and the frames' time
embeddings are of 0 .. T-1, the model's own steps when it is given none.

Departures from EGNO/model/egno.py: the graph is a dense [N, N] mask and
attribute matrix in place of its edge lists, so each node's sums over its
edges run over all N in another order (the same terms, those of a masked
pair zero); the coordinate mean divides by the mask's degree, as the
edge-list mean divides by the node's edge count. The parameters are a
name -> tensor dict in the program's leaf names (``egno.param_specs``
with one node feature and one edge feature)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import draw, linear
from .egno import (egnn_layer, modes_kept, param_specs, spectral,
                   timestep_embedding)


def draw_weights(cfg, k, generator, device):
    """K weight sets {name: [K, ...]} drawn within the init bounds."""
    return draw(param_specs(cfg), k, generator, device)


def forward(p, cfg, x0, v0, edge_attr, edge_mask):
    """x0, v0 [B, N, 3]; edge_attr [N, N, E]; edge_mask [N, N] -> the
    decoded positions [T, B, N, 3]."""
    t = cfg["num_timesteps"]
    modes = modes_kept(cfg)
    b, n = x0.shape[:2]
    nodes = x0[..., 1:2] / 10.0
    mean = x0.mean(dim=-2, keepdim=True).expand(x0.shape)
    steps = torch.arange(t, dtype=x0.dtype, device=x0.device).expand(b, t)
    emb = timestep_embedding(steps, cfg["time_emb_dim"]).transpose(0, 1)
    h = torch.cat([nodes.expand(t, *nodes.shape),
                   emb[:, :, None, :].expand(t, b, n, emb.shape[-1])], -1)
    h = linear(p, "embedding", h)
    x = x0.expand(t, *x0.shape)
    v = v0.expand(t, *v0.shape)
    xm = mean.expand(t, *mean.shape)
    e = edge_attr.expand(t, b, *edge_attr.shape)
    for i in range(cfg["n_layers"]):
        h = h + F.leaky_relu(spectral(
            h, p[f"time_conv_modules.{i}.t_conv.weights1"], modes), 0.01)
        st = torch.stack([x - xm, v], dim=-1)
        st = st + spectral(st, p[f"time_conv_x_modules.{i}.t_conv.weights1"],
                           modes)
        x, v = st[..., 0] + xm, st[..., 1]
        x, h = egnn_layer(p, f"layers.{i}", x, h, e, v, edge_mask)
    return x


def train_loss(p, cfg, split, idx):
    """(loss, [loss]) of the batch of samples ``idx``: the mean squared
    error of the decoded frames against the target window, over every
    sample, frame, joint and coordinate. ``split``: {x0, v0, xt,
    edge_attr, edge_mask} tensors, xt [S, T, N, 3]."""
    x = forward(p, cfg, split["x0"][idx], split["v0"][idx],
                split["edge_attr"], split["edge_mask"])
    loss = ((x - split["xt"][idx].transpose(0, 1)) ** 2).mean()
    return loss, loss[None]
