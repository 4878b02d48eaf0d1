"""EGNO: Equivariant Graph Neural Operator (counterpart of
nonode_tpu/models/egno.py:30-163).

An EGNN stack where every layer is preceded by temporal spectral
convolutions on the node features (TimeConv) and on the stacked equivariant
pair (x - x_mean, v) (TimeConvX). The model decodes all ``num_timesteps``
future frames in one forward pass; states are [T, B, N, .].
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import Linear, silu
from ..ops.dense_graph import EGNNLayer
from ..ops.spectral import TimeConv, TimeConvX, timestep_embedding
from ..runtime import resolve_device


def input_slot_map(num_inputs: int, t: int, device=None) -> torch.Tensor:
    """Slot s -> input index [T], as repeat_elements_to_exact_shape: each
    input repeated T//L times in order, remainder slots take the last.
    Made on ``device``: a host list copied there is a transfer that a CUDA
    graph cannot capture."""
    k = t // num_inputs
    slots = torch.arange(t, device=device)
    if k == 0:                     # fewer slots than inputs: all the last
        return torch.full_like(slots, num_inputs - 1)
    return (slots // k).clamp(max=num_inputs - 1)


def effective_num_modes(num_timesteps: int, num_modes: int) -> int:
    """The reference's clamp rule (egno.py:26)."""
    if num_timesteps != 5:
        return min(num_timesteps, num_modes)
    return min(num_modes, 3)


class EGNO(nn.Module):
    def __init__(self, n_layers: int = 4, in_node_nf: int = 2,
                 in_edge_nf: int = 2, hidden_nf: int = 64, num_modes: int = 2,
                 num_timesteps: int = 10, time_emb_dim: int = 32,
                 num_inputs: int = 1, varDT: bool = False, with_v: bool = True,
                 flat: bool = False, norm: bool = False,
                 use_time_conv: bool = True, fused: bool = True, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.n_layers = n_layers
        self.num_timesteps = num_timesteps
        self.time_emb_dim = time_emb_dim
        self.num_inputs = num_inputs
        self.varDT = varDT
        self.use_time_conv = use_time_conv
        modes = effective_num_modes(num_timesteps, num_modes)
        # the time embedding is appended to the node features, twice (in and
        # out) when there are several input snapshots (egno.py:13-16)
        in_nf = in_node_nf + time_emb_dim * (2 if num_inputs > 1 else 1)
        kw = dict(device=device, generator=generator)
        self.embedding = Linear(in_nf, hidden_nf, **kw)
        self.layers = nn.ModuleList([
            EGNNLayer(hidden_nf, in_edge_nf, act=silu, with_v=with_v,
                      flat=flat, norm=norm, fused=fused, **kw)
            for _ in range(n_layers)])
        if use_time_conv:
            self.time_conv_modules = nn.ModuleList([
                TimeConv(hidden_nf, modes, **kw) for _ in range(n_layers)])
            self.time_conv_x_modules = nn.ModuleList([
                TimeConvX(2, modes, **kw) for _ in range(n_layers)])

    def forward(self, loc, vel, nodes, edge_attr, loc_mean,
                timesteps_out=None, timesteps_in=None, edge_mask=None,
                rows=None):
        """Decode ``num_timesteps`` frames.

        Single input: loc, vel, loc_mean [B, N, 3]; nodes [B, N, F];
        edge_attr [B, N, N, E]. Several inputs: a leading L = num_inputs
        axis on all of these. timesteps_out: [B, T] (default arange(T));
        timesteps_in: [B, L] (default arange(-L+1, 1)). ``rows``
        (ops.dense_graph.ReceiverRows): the node tensors hold the receivers
        [i0, i0 + ni), edge_attr [.., ni, N, E], and loc_mean is the mean
        over all N; every other operation is per node.

        Returns x, v, h with shape [T, B, N, .].
        """
        t = self.num_timesteps
        multi = self.num_inputs > 1
        b = loc.shape[1] if multi else loc.shape[0]
        dev = loc.device

        if timesteps_out is None:
            timesteps_out = torch.arange(t, dtype=torch.float32,
                                         device=dev).expand(b, t)
        emb_out = timestep_embedding(timesteps_out, self.time_emb_dim)

        if multi:
            slot = input_slot_map(self.num_inputs, t, dev)
            if timesteps_in is None:
                timesteps_in = torch.arange(
                    -self.num_inputs + 1, 1, dtype=torch.float32,
                    device=dev).expand(b, self.num_inputs)
            emb_in = timestep_embedding(timesteps_in[:, slot],
                                        self.time_emb_dim)     # [B, T, Ht]
            # map L input snapshots onto T slots
            x = loc[slot]                                      # [T, B, N, 3]
            v = vel[slot]
            h0 = nodes[slot]
            x_mean = loc_mean[slot]
            e_fea = edge_attr[slot]                            # [T, B, N, N, E]
            embs = [emb_in.transpose(0, 1), emb_out.transpose(0, 1)]
        else:
            x = loc.expand(t, *loc.shape)
            v = vel.expand(t, *vel.shape)
            h0 = nodes.expand(t, *nodes.shape)
            x_mean = loc_mean.expand(t, *loc_mean.shape)
            e_fea = edge_attr.expand(t, *edge_attr.shape)
            embs = [emb_out.transpose(0, 1)]                   # [T, B, Ht]

        n = x.shape[2]
        embs = [e[:, :, None, :].expand(t, b, n, e.shape[-1]).to(h0.dtype)
                for e in embs]
        h = torch.cat([h0, *embs], dim=-1)                     # [T, B, N, F+k*Ht]
        h = self.embedding(h)                                  # [T, B, N, H]

        for i in range(self.n_layers):
            if self.use_time_conv:
                h = self.time_conv_modules[i](h)
                stacked = torch.stack([x - x_mean, v], dim=-1)  # [T, B, N, 3, 2]
                out = self.time_conv_x_modules[i](stacked)
                x = out[..., 0] + x_mean
                v = out[..., 1]
            x, v, h = self.layers[i](x, h, e_fea, v=v, edge_mask=edge_mask,
                                     rows=rows)
        return x, v, h
