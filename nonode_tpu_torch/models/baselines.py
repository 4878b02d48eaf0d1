"""The baseline model zoo (counterpart of nonode_tpu/models/baselines.py).

GNN, LinearDynamics, RFVel, EquivariantScalarNet, EGMN and FullMLP on the
dense [.., N, N, .] formulation, with the JAX package's constructor
arguments, call signatures and inits. Their parameters sit under the JAX
trees' keys (``embedding``, ``edge.{i}``, ``node.{i}``, ``decoder``,
``layers.{i}.phi_l1``, ...), every MLP's Linears under ``mlp.{0,2}``; JAX
weights cross through ``compat.params.baseline_state_dict_from_jax_params``.
No entry point runs them, in JAX or in the reference (basic.py), and they
reach no kernel: plain PyTorch is their port.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import MLP, Linear, silu, xavier_uniform
from ..ops.dense_graph import masked_mean_j, offdiag_mask, pairwise_diff
from ..runtime import resolve_device


class GNN(nn.Module):
    """Message-passing baseline: h-only updates and a 3D decoder."""

    def __init__(self, n_layers: int, in_node_nf: int, in_edge_nf: int,
                 hidden_nf: int, flat: bool = False, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        h = hidden_nf
        self.embedding = Linear(in_node_nf, h, **kw)
        self.edge = nn.ModuleList([
            MLP(in_edge_nf + 2 * h, h, h, silu, flat=flat, **kw)
            for _ in range(n_layers)])
        self.node = nn.ModuleList([
            MLP(2 * h, h, h, silu, flat=flat, **kw) for _ in range(n_layers)])
        self.decoder = MLP(h, h, 3, silu, **kw)

    def forward(self, h, edge_fea):
        """h: [..., N, F]; edge_fea: [..., N, N, E] -> [..., N, 3]."""
        mask = offdiag_mask(h.shape[-2], h.dtype, h.device)
        h = self.embedding(h)
        for edge, node in zip(self.edge, self.node):
            pair = (*edge_fea.shape[:-1], h.shape[-1])
            hi = h[..., :, None, :].expand(pair)
            hj = h[..., None, :, :].expand(pair)
            msg = edge(torch.cat([hi, hj, edge_fea], dim=-1))
            agg = masked_mean_j(msg, mask)
            h = h + node(torch.cat([agg, h], dim=-1))
        return self.decoder(h)


class LinearDynamics(nn.Module):
    """x + v * t with one learned scalar t (basic.py:277-285)."""

    def __init__(self, *, device=None, generator=None):
        super().__init__()
        del generator                         # t starts at 1
        self.time = nn.Parameter(torch.ones(1, device=resolve_device(device)))

    def forward(self, x, v):
        return x + v * self.time


class _RFLayer(nn.Module):
    def __init__(self, hidden_nf: int, edge_attr_nf: int, **kw):
        super().__init__()
        self.vel_mlp = MLP(1, hidden_nf, 1, silu, **kw)
        self.phi_l1 = Linear(1 + edge_attr_nf, hidden_nf, **kw)
        # xavier_uniform(gain=0.001) and no bias, as
        # nonode_tpu/models/baselines.py:112-118 draws it
        self.phi_l2 = Linear(hidden_nf, 1, bias=False, **kw)
        with torch.no_grad():
            self.phi_l2.weight.copy_(xavier_uniform((1, hidden_nf), 0.001,
                                                    **kw))


class RFVel(nn.Module):
    """Radial-field baseline with a velocity gate (basic.py:288-339).

    As in the JAX package, the dense radial sqrt(|x_i - x_j|^2) is taken on
    the diagonal too, where it is 0: the masked edge passes a zero
    cotangent to it and sqrt's derivative there is infinite, so every
    gradient through x is NaN, and with it every parameter's gradient but
    the last layer's. The reference's edge list has no self-edges."""

    def __init__(self, hidden_nf: int = 64, edge_attr_nf: int = 0,
                 n_layers: int = 4, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.layers = nn.ModuleList([_RFLayer(hidden_nf, edge_attr_nf, **kw)
                                     for _ in range(n_layers)])

    def forward(self, vel_norm, x, vel, edge_attr):
        """vel_norm: [..., N, 1]; x, vel: [..., N, 3]; edge_attr
        [..., N, N, E] -> x [..., N, 3]."""
        mask = offdiag_mask(x.shape[-2], x.dtype, x.device)
        for layer in self.layers:
            diff = pairwise_diff(x)
            radial = torch.sqrt((diff * diff).sum(-1, keepdim=True))
            e_in = torch.cat([radial, edge_attr], dim=-1)
            # RF_vel passes SiLU into GCL_rf_vel (basic.py:289, 295): phi
            # and the velocity gate share it
            e = torch.tanh(layer.phi_l2(silu(layer.phi_l1(e_in))))
            x = x + masked_mean_j(diff * e, mask)
            x = x + vel * layer.vel_mlp(vel_norm)
        return x


class EquivariantScalarNet(nn.Module):
    """Universal O(n)-equivariant net on the Gram matrix of its input
    vectors (basic.py:61-104): scalars = flatten(Z^T Z) [+ extra scalars]
    -> MLP; the output vector is Z @ the vector head's weights, the output
    scalars a second head's."""

    def __init__(self, n_vector_input: int, hidden_dim: int,
                 n_scalar_input: int = 0, norm: bool = True,
                 flat: bool = True, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.norm = norm
        self.in_scalar = MLP(n_vector_input ** 2 + n_scalar_input,
                             hidden_dim, hidden_dim, silu, last_act=True,
                             flat=flat, **kw)
        self.out_vector = MLP(hidden_dim, hidden_dim, n_vector_input, silu,
                              flat=flat, **kw)
        self.out_scalar = MLP(hidden_dim, hidden_dim, hidden_dim, silu,
                              flat=flat, **kw)

    def forward(self, vectors, scalars=None):
        """vectors: [..., 3, K], K stacked vectors (or a list of [..., 3]).
        Returns (vector [..., 3], scalars [..., H])."""
        z = torch.stack(list(vectors), dim=-1) \
            if isinstance(vectors, (list, tuple)) else vectors
        k = z.shape[-1]
        gram = torch.einsum("...dk,...dl->...kl", z, z)
        s = gram.reshape(*gram.shape[:-2], k * k)
        if self.norm:
            nrm = torch.sqrt((s * s).sum(-1, keepdim=True))
            s = s / nrm.clamp(min=1e-12)
        if scalars is not None:
            s = torch.cat([s, scalars], dim=-1)
        s = self.in_scalar(s)
        vector = torch.einsum("...dk,...k->...d", z, self.out_vector(s))
        return vector, self.out_scalar(s)


class EGMN(nn.Module):
    """Equivariant multi-layer net over a growing vector basis
    (basic.py:215-231): layer i takes the input vectors and every vector
    produced before it, and ``hidden_dim`` scalars after the first."""

    def __init__(self, n_layers: int, n_vector_input: int, hidden_dim: int,
                 n_scalar_input: int, norm: bool = False, flat: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.layers = nn.ModuleList([
            EquivariantScalarNet(
                n_vector_input + i, hidden_dim,
                n_scalar_input if i == 0 else hidden_dim, norm=norm,
                flat=flat, **kw)
            for i in range(n_layers)])

    def forward(self, vectors, scalars):
        """vectors: a list of [..., 3]; scalars [..., S]."""
        cur = list(vectors)
        for layer in self.layers:
            vector, scalars = layer(cur, scalars)
            cur.append(vector)
        return cur[-1], scalars


class FullMLP(nn.Module):
    """A residual MLP stack that ignores the graph (basic.py:352-367)."""

    def __init__(self, in_node_nf: int, hidden_nf: int, n_layers: int,
                 flat: bool = False, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        h = hidden_nf
        self.embedding = Linear(in_node_nf, h, **kw)
        self.blocks = nn.ModuleList([
            MLP(h, h, h, silu, last_act=True, flat=flat, residual=True, **kw)
            for _ in range(n_layers)])
        self.output = Linear(h, 3, **kw)

    def forward(self, x):
        h = self.embedding(x)
        for block in self.blocks:
            h = block(h)
        return self.output(h)
