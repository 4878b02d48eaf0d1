"""SEGNO (Second-order Equivariant Graph Neural ODE) in plain PyTorch,
float32: one weight-tied second-order GCL integrated ``num_timesteps``
times with step 1/T (SEGNO/models/model.py:95-102 and gcl.py:26-119 of
the NO-NODE-comparison repository), one input frame.

A step: the edge MLP over [h_i, h_j, |x_i - x_j|^2, e_ij], both layers
activated; (x_i - x_j) * coord(m_ij) clipped to +-100 per edge, its mean
over the other nodes; v += agg / T, x += v / T; h = node(h, sum_j m_ij),
added to h when the configuration is recurrent."""

from __future__ import annotations

import math

import torch

from .common import (charged_energy, complete_graph_mask, draw, linear,
                     linear_spec, mlp2, node_edge_features)


def param_specs(cfg):
    """(name, shape, low, high) of every parameter, with its init bounds;
    the last coordinate layer's weight is xavier-uniform with gain 0.001
    (gcl.py:50-51)."""
    h, e = cfg["nf"], cfg["in_edge_nf"]
    specs = linear_spec("embedding", cfg["in_node_nf"], h)
    specs += linear_spec("module.edge_mlp.0", 2 * h + 1 + e, h)
    specs += linear_spec("module.edge_mlp.2", h, h)
    specs += linear_spec("module.node_mlp.0", 2 * h, h)
    specs += linear_spec("module.node_mlp.2", h, h)
    specs += linear_spec("module.coord_mlp.0", h, h)
    head = linear_spec("module.coord_mlp.2", h, 1)
    bound = 0.001 * math.sqrt(6.0 / (h + 1))
    return specs + [(head[0][0], head[0][1], -bound, bound), head[1]]


def draw_weights(cfg, k, generator, device):
    """K weight sets {name: [K, ...]} drawn within the init bounds."""
    return draw(param_specs(cfg), k, generator, device)


def gcl(p, h, x, v, e, inv, mask, recurrent):
    """One integrator step of the GCL on the complete graph."""
    n, hd = x.shape[-2], h.shape[-1]
    rij = x[..., :, None, :] - x[..., None, :, :]
    radial = (rij * rij).sum(-1, keepdim=True)
    lead = h.shape[:-2]
    hi = h[..., :, None, :].expand(*lead, n, n, hd)
    hj = h[..., None, :, :].expand(*lead, n, n, hd)
    ef = mlp2(p, "module.edge_mlp", torch.cat([hi, hj, radial, e], dim=-1),
              last_act=True)
    coord = mlp2(p, "module.coord_mlp", ef)
    m = mask[..., None]
    degree = mask.sum(-1, keepdim=True).clamp(min=1.0)
    agg = ((rij * coord).clamp(-100.0, 100.0) * m).sum(-2) / degree
    msg = (ef * m).sum(-2)
    v = v + agg * inv
    x = x + v * inv
    out = mlp2(p, "module.node_mlp", torch.cat([h, msg], dim=-1))
    return (h + out if recurrent else out), x, v


def forward(p, cfg, loc, vel, charges):
    """loc, vel [B, N, 3], charges [B, N, 1] -> (x, v) T steps ahead."""
    speed, e, _ = node_edge_features(loc, vel, charges)
    h = linear(p, "embedding", speed)
    mask = complete_graph_mask(loc.shape[-2], loc)
    steps = cfg["num_timesteps"]
    x, v = loc, vel
    for _ in range(steps):
        h, x, v = gcl(p, h, x, v, e, 1.0 / steps, mask, cfg["recurrent"])
    return x, v


def train_loss(p, cfg, split, idx):
    """(loss, per-frame losses [1]) of the batch of samples ``idx``: the
    mean squared error of the positions T frames after frame_0."""
    f0, t = cfg["frame_0"], cfg["num_timesteps"]
    loc, vel = split["loc"][idx], split["vel"][idx]
    x, _ = forward(p, cfg, loc[:, f0], vel[:, f0], split["charges"][idx])
    loss = ((x - loc[:, f0 + t]) ** 2).mean()
    return loss, loss[None]


def compared_frames(cfg) -> int:
    """Every window of the test evaluation is kept (train_nbody.py:200),
    one frame each."""
    return cfg["traj_len"]


def rolled_frames(cfg) -> int:
    """The frames a test evaluation rolls out: the same, every window."""
    return cfg["traj_len"]


def frames_per_window(cfg) -> int:
    """A window steps T ahead to one frame."""
    return 1


def rollout(p, cfg, split, idx, frames):
    """``frames`` fed-back windows from frame_0 of the samples ``idx``,
    each T integrator steps ahead. Returns the positions [frames, B, N, 3],
    their energies [frames, B] and the velocities [frames, B, N, 3]."""
    f0 = cfg["frame_0"]
    loc, vel = split["loc"][idx, f0], split["vel"][idx, f0]
    charges = split["charges"][idx]
    xs, vs = [], []
    for _ in range(frames):
        loc, vel = forward(p, cfg, loc, vel, charges)
        xs.append(loc)
        vs.append(vel)
    xs, vs = torch.stack(xs), torch.stack(vs)
    qq = charges[:, :, 0][:, :, None] * charges[:, :, 0][:, None, :]
    return xs, charged_energy(xs, vs, qq), vs


def truth(cfg, split, idx, frames):
    """The data's frames the rollout predicts, [frames, B, N, 3]."""
    f0, t = cfg["frame_0"], cfg["num_timesteps"]
    return split["loc"][idx][:, [f0 + t * (w + 1) for w in range(frames)]] \
        .transpose(0, 1)
