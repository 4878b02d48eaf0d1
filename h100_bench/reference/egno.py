"""EGNO (Equivariant Graph Neural Operator) in plain PyTorch, float32:
an EGNN stack whose layers are each preceded by temporal spectral
convolutions, decoding ``num_timesteps`` future frames of an N-body system
in one pass (states are [T, B, N, .]).

Written from the model's equations (EGNO/model/egno.py and basic.py of the
NO-NODE-comparison repository): per layer, h += LeakyReLU(SpectralConv(h));
(x - mean x, v) += SpectralConv((x - mean x, v)); then the EGNN layer with
the edge MLP over the concatenation [|x_i - x_j|^2, h_i, h_j, e_ij], the
mean of (x_i - x_j) * coord(m_ij) over the other nodes clipped to +-100,
the velocity gate x += node_v(h) * v, and h = node(h, sum_j m_ij)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (charged_energy, complete_graph_mask, draw, linear,
                     linear_spec, mlp2, node_edge_features)


def modes_kept(cfg) -> int:
    """The frequencies each spectral convolution keeps (egno.py:26)."""
    t, m = cfg["num_timesteps"], cfg["num_modes"]
    return min(m, 3) if t == 5 else min(t, m)


def param_specs(cfg):
    """(name, shape, low, high) of every parameter, with its init bounds."""
    h, e, ht = cfg["nf"], cfg["in_edge_nf"], cfg["time_emb_dim"]
    modes = modes_kept(cfg)
    specs = linear_spec("embedding", cfg["in_node_nf"] + ht, h)
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}"
        specs += linear_spec(f"{p}.edge_message_net.scalar_net.mlp.0",
                             1 + 2 * h + e, h)
        specs += linear_spec(f"{p}.edge_message_net.scalar_net.mlp.2", h, h)
        specs += linear_spec(f"{p}.coord_net.mlp.0", h, h)
        specs += linear_spec(f"{p}.coord_net.mlp.2", h, 1)
        specs += linear_spec(f"{p}.node_v_net.mlp.0", h, h)
        specs += linear_spec(f"{p}.node_v_net.mlp.2", h, 1)
        specs += linear_spec(f"{p}.node_net.mlp.0", 2 * h, h)
        specs += linear_spec(f"{p}.node_net.mlp.2", h, h)
    for i in range(cfg["n_layers"]):
        specs.append((f"time_conv_modules.{i}.t_conv.weights1",
                      (h, h, modes, 2), 0.0, 1.0 / (h * h)))
    for i in range(cfg["n_layers"]):
        specs.append((f"time_conv_x_modules.{i}.t_conv.weights1",
                      (2, 2, modes, 2), 0.0, 0.1))
    return specs


def draw_weights(cfg, k, generator, device):
    """K weight sets {name: [K, ...]} drawn within the init bounds."""
    return draw(param_specs(cfg), k, generator, device)


def timestep_embedding(t, dim, max_positions=10000):
    """Sinusoidal embedding of [B, T] timesteps -> [B, T, dim]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device, dtype=t.dtype)
                      * -(math.log(max_positions) / (half - 1)))
    args = t[..., None] * freqs
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def spectral(x, w, modes):
    """Fourier layer over the leading time axis of [T, ..., C]: the first
    ``modes`` frequencies of the real FFT times complex weights w [C, C',
    modes, 2], back to T frames; the zero frequency (and, for even T, the
    Nyquist one) of a real signal is real."""
    t = x.shape[0]
    x_ft = torch.fft.rfft(x, dim=0)[:modes]
    wc = torch.complex(w[..., 0], w[..., 1])
    out = torch.einsum("m...i,iom->m...o", x_ft, wc)
    imag = out.imag.clone()
    imag[0] = 0.0
    if t % 2 == 0 and out.shape[0] > t // 2:
        imag[t // 2] = 0.0
    return torch.fft.irfft(torch.complex(out.real, imag), n=t, dim=0)


def egnn_layer(p, name, x, h, e, v, mask):
    """One EGNN layer on the complete graph: (x, h) after it."""
    n, hd = x.shape[-2], h.shape[-1]
    rij = x[..., :, None, :] - x[..., None, :, :]
    r2 = (rij * rij).sum(-1, keepdim=True)
    lead = h.shape[:-2]
    hi = h[..., :, None, :].expand(*lead, n, n, hd)
    hj = h[..., None, :, :].expand(*lead, n, n, hd)
    msg = mlp2(p, f"{name}.edge_message_net.scalar_net.mlp",
               torch.cat([r2, hi, hj, e], dim=-1), last_act=True)
    cw = mlp2(p, f"{name}.coord_net.mlp", msg)
    m = mask[..., None]
    degree = mask.sum(-1, keepdim=True).clamp(min=1.0)
    tot_f = ((rij * cw * m).sum(-2) / degree).clamp(-100.0, 100.0)
    tot_m = (msg * m).sum(-2)
    x = x + mlp2(p, f"{name}.node_v_net.mlp", h) * v + tot_f
    h = mlp2(p, f"{name}.node_net.mlp", torch.cat([h, tot_m], dim=-1))
    return x, h


def forward(p, cfg, loc, vel, charges, t_out):
    """loc, vel [B, N, 3], charges [B, N, 1], t_out [B, T] -> x, v
    [T, B, N, 3]."""
    t = cfg["num_timesteps"]
    modes = modes_kept(cfg)
    speed, edge, _ = node_edge_features(loc, vel, charges)
    nodes = torch.cat([speed, charges], dim=-1)
    b, n = loc.shape[:2]
    mean = loc.mean(dim=-2, keepdim=True).expand(loc.shape)
    emb = timestep_embedding(t_out, cfg["time_emb_dim"]).transpose(0, 1)
    h = torch.cat([nodes.expand(t, *nodes.shape),
                   emb[:, :, None, :].expand(t, b, n, emb.shape[-1])], -1)
    h = linear(p, "embedding", h)
    x = loc.expand(t, *loc.shape)
    v = vel.expand(t, *vel.shape)
    xm = mean.expand(t, *mean.shape)
    e = edge.expand(t, *edge.shape)
    mask = complete_graph_mask(n, loc)
    for i in range(cfg["n_layers"]):
        h = h + F.leaky_relu(spectral(
            h, p[f"time_conv_modules.{i}.t_conv.weights1"], modes), 0.01)
        st = torch.stack([x - xm, v], dim=-1)
        st = st + spectral(st, p[f"time_conv_x_modules.{i}.t_conv.weights1"],
                           modes)
        x, v = st[..., 0] + xm, st[..., 1]
        x, h = egnn_layer(p, f"layers.{i}", x, h, e, v, mask)
    return x, v


def _offsets(cfg, b, device, dtype):
    """The decoded frames' offsets 1..T from the input frame, [B, T]."""
    t = cfg["num_timesteps"]
    return torch.arange(1, t + 1, dtype=dtype, device=device).expand(b, t)


def train_loss(p, cfg, split, idx):
    """(loss, per-frame losses [T]) of the batch of samples ``idx``: the
    T frames after frame_0 predicted from it, squared error summed over
    the batch and divided by B * N * 3, the mean over the frames the
    target."""
    f0, t = cfg["frame_0"], cfg["num_timesteps"]
    loc, vel = split["loc"][idx], split["vel"][idx]
    x, _ = forward(p, cfg, loc[:, f0], vel[:, f0], split["charges"][idx],
                   _offsets(cfg, len(idx), loc.device, loc.dtype))
    target = loc[:, f0 + 1:f0 + 1 + t].transpose(0, 1)
    sq = (x - target) ** 2
    losses = sq.sum(dim=(1, 2, 3)) / sq[0].numel()
    return losses.mean(), losses


def compared_frames(cfg) -> int:
    """The frames a test evaluation keeps: the first 40% of the horizon
    (main_simulation_simple_no.py:374)."""
    return int(0.4 * cfg["traj_len"] * cfg["num_timesteps"])


def rolled_frames(cfg) -> int:
    """The frames a test evaluation rolls out: ``traj_len`` windows of T."""
    return cfg["traj_len"] * cfg["num_timesteps"]


def frames_per_window(cfg) -> int:
    """A window decodes T frames."""
    return cfg["num_timesteps"]


def window(p, cfg, loc, vel, charges):
    """One window from the state loc, vel [B, N, 3]: the T frames it
    decodes, x and v [T, B, N, 3]."""
    return forward(p, cfg, loc, vel, charges,
                   _offsets(cfg, len(loc), loc.device, loc.dtype))


def rollout(p, cfg, split, idx, frames):
    """Fed-back windows from frame_0 of the samples ``idx`` until
    ``frames`` frames are decoded: each window decodes T frames and its
    last frame's (x, v) starts the next. Returns the positions [frames, B,
    N, 3], the energy of each frame [frames, B] and the velocities
    [frames, B, N, 3]."""
    f0, t = cfg["frame_0"], cfg["num_timesteps"]
    loc, vel = split["loc"][idx, f0], split["vel"][idx, f0]
    charges = split["charges"][idx]
    xs, vs = [], []
    for _ in range(-(-frames // t)):
        x, v = window(p, cfg, loc, vel, charges)
        xs.append(x)
        vs.append(v)
        loc, vel = x[-1], v[-1]
    xs, vs = torch.cat(xs)[:frames], torch.cat(vs)[:frames]
    qq = charges[:, :, 0][:, :, None] * charges[:, :, 0][:, None, :]
    return xs, charged_energy(xs, vs, qq), vs


def truth(cfg, split, idx, frames):
    """The data's frames the rollout predicts, [frames, B, N, 3]."""
    f0 = cfg["frame_0"]
    return split["loc"][idx, f0 + 1:f0 + 1 + frames].transpose(0, 1)
