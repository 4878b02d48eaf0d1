"""Dense pairwise graph ops and the EGNN layer (counterpart of
nonode_tpu/ops/dense_graph.py:32-228).

Fully connected graphs are dense ``[..., N, N, .]`` tensors with an
off-diagonal mask; edge (i, j) carries the message node i receives from
node j. Aggregation is a masked sum or mean over j.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..nn import MLP, Linear, silu
from .kernels import egnn_fused


def offdiag_mask(n: int, dtype=torch.float32, device=None):
    """[N, N] mask that zeroes self-edges (the diagonal)."""
    return 1.0 - torch.eye(n, dtype=dtype, device=device)


def pairwise_diff(x):
    """x: [..., N, D] -> r[..., i, j, :] = x_i - x_j."""
    return x[..., :, None, :] - x[..., None, :, :]


def masked_sum_j(m, mask):
    """m: [..., N, N, K]; mask: [..., N, N]. Sum over j with masked edges
    zeroed."""
    return (m * mask[..., None]).sum(dim=-2)


def masked_mean_j(m, mask):
    """Mean over unmasked j; the divisor is the per-node degree clamped at 1
    (the reference's count.clamp(min=1))."""
    degree = mask.sum(dim=-1)[..., None]
    return masked_sum_j(m, mask) / degree.clamp(min=1.0)


def _l2_normalize(x, dim=-1, eps=1e-12):
    """torch F.normalize(p=2): x / max(||x||, eps)."""
    norm = torch.sqrt((x * x).sum(dim=dim, keepdim=True))
    return x / norm.clamp(min=eps)


def first_edge_linear(lin: Linear, segments):
    """First Linear of an edge MLP over ``concat(segments)`` without building
    the wide ``[..., N, N, sum(k)]`` concat.

    ``segments`` are ordered ``(tensor, kind)`` pairs in the concat layout
    the weights were made for: 'pair' is a pairwise feature
    ``[..., N, N, k]``; 'i' / 'j' are node features ``[..., N, k]`` broadcast
    over the sender / receiver axis. A product over a concat is the sum of
    per-slice products, so node slices cost O(N) instead of O(N^2).
    """
    w = lin.weight
    dtypes = {t.dtype for t, _ in segments}
    if len(dtypes) != 1:
        raise TypeError(f"first_edge_linear segments mix dtypes {dtypes}")
    off = 0
    acc = {"pair": None, "i": None, "j": None}
    for t, kind in segments:
        k = t.shape[-1]
        y = t @ w[:, off:off + k].T
        acc[kind] = y if acc[kind] is None else acc[kind] + y
        off += k
    if off != w.shape[1]:
        raise ValueError(f"segments span {off} inputs, weight has {w.shape[1]}")
    out = acc["pair"]
    if acc["i"] is not None:
        out = out + acc["i"][..., :, None, :]
    if acc["j"] is not None:
        out = out + acc["j"][..., None, :, :]
    return out + lin.bias


class _ScalarNet(nn.Module):
    """Holds the edge MLP under the reference name
    ``edge_message_net.scalar_net`` (InvariantScalarNet)."""

    def __init__(self, mlp: MLP):
        super().__init__()
        self.scalar_net = mlp


class EGNNLayer(nn.Module):
    """Dense EGNN layer (EGNO/model/basic.py:147-186 semantics).

    Edge message from an MLP over [||r_ij||^2, h_i, h_j, edge_fea]; per-edge
    scalar coordinate weight; mean-aggregated force clipped to +-100 after
    the mean; optional velocity gate ``x += node_v_net(h) * v``; node update
    from [h, sum_j message].

    ``fused`` routes the pairwise chain through ops.kernels.egnn_fused when
    the config passes its gate (the CUDA kernel on the card, its plain
    version on the CPU); otherwise the dense path runs.
    """

    def __init__(self, hidden_nf: int, in_edge_nf: int, act: Callable = silu,
                 with_v: bool = False, flat: bool = False, norm: bool = False,
                 h_update: bool = True, fused: bool = True, *, device=None,
                 generator=None):
        super().__init__()
        self.hidden_nf = hidden_nf
        self.in_edge_nf = in_edge_nf
        self.act = act
        self.with_v = with_v
        self.flat = flat
        self.norm = norm
        self.h_update = h_update
        self.fused = fused
        kw = dict(device=device, generator=generator)
        self.edge_message_net = _ScalarNet(MLP(
            1 + 2 * hidden_nf + in_edge_nf, hidden_nf, hidden_nf, act,
            last_act=True, flat=flat, **kw))
        self.coord_net = MLP(hidden_nf, hidden_nf, 1, act, flat=flat, **kw)
        if with_v:
            self.node_v_net = MLP(hidden_nf, hidden_nf, 1, act, flat=flat, **kw)
        if h_update:
            self.node_net = MLP(2 * hidden_nf, hidden_nf, hidden_nf, act,
                                flat=flat, **kw)

    @property
    def edge_net(self) -> MLP:
        return self.edge_message_net.scalar_net

    def _use_fused(self, x, edge_mask) -> bool:
        return (self.fused and self.in_edge_nf >= 1
                and (edge_mask is None or edge_mask.dim() == 2)
                and egnn_fused.supported(x.shape[-2], self.hidden_nf, x.dtype,
                                         self.act, self.flat, self.norm))

    def _fused_pairwise(self, x, h, edge_fea, mask):
        """The pairwise chain through the fused kernels: leading dims flatten
        to one graph axis, and the h_i / h_j column slices of the first edge
        Linear are projected per node here (as first_edge_linear does). The
        nine weights are slices, transposes and row views of the Linear
        parameters, so the backward's weight gradients reach them through
        autograd."""
        hdim, e = self.hidden_nf, self.in_edge_nf
        lead = x.shape[:-2]
        n = x.shape[-2]
        g = 1
        for d in lead:
            g *= d
        l1, l2 = self.edge_net.mlp[0], self.edge_net.mlp[2]
        c1, c2 = self.coord_net.mlp[0], self.coord_net.mlp[2]
        w1 = l1.weight                                   # [H, 1+2H+E]
        wi, wj = w1[:, 1:1 + hdim], w1[:, 1 + hdim:1 + 2 * hdim]
        hi = h @ wi.T
        hj = h @ wj.T
        weights = (w1[:, :1].T, w1[:, 1 + 2 * hdim:].T, l1.bias[None, :],
                   l2.weight.T, l2.bias[None, :],
                   c1.weight.T, c1.bias[None, :],
                   c2.weight.T, c2.bias[None, :])        # wc2 [H,1], bc2 [1,1]
        ef = edge_fea.expand(*lead, n, n, e)
        tot_f, tot_m = egnn_fused.pairwise_message(
            False,
            x.reshape(g, n, 3).contiguous(), hi.reshape(g, n, hdim).contiguous(),
            hj.reshape(g, n, hdim).contiguous(),
            ef.reshape(g, n, n, e).contiguous(), mask.contiguous(), weights)
        return tot_f.reshape(*lead, n, 3), tot_m.reshape(*lead, n, hdim)

    def forward(self, x, h, edge_fea, v=None, edge_mask=None):
        """x: [..., N, 3]; h: [..., N, H]; edge_fea: [..., N, N, E].

        edge_mask: optional [..., N, N] 0/1 mask restricting the graph;
        defaults to the complete graph."""
        n = x.shape[-2]
        mask = offdiag_mask(n, x.dtype, x.device)
        if edge_mask is not None:
            mask = mask * edge_mask

        if self._use_fused(x, edge_mask):
            tot_f, tot_message = self._fused_pairwise(x, h, edge_fea, mask)
        else:
            rij = pairwise_diff(x)
            r2 = (rij * rij).sum(dim=-1, keepdim=True)
            gram = _l2_normalize(r2) if self.norm else r2
            pre = first_edge_linear(
                self.edge_net.mlp[0],
                [(gram, "pair"), (h, "i"), (h, "j"), (edge_fea, "pair")])
            message = self.edge_net.from_preact(pre)
            coord_w = self.coord_net(message)
            tot_f = masked_mean_j(rij * coord_w, mask)
            tot_message = masked_sum_j(message, mask)
        tot_f = tot_f.clamp(-100.0, 100.0)

        if v is not None:
            x = x + self.node_v_net(h) * v + tot_f
        else:
            x = x + tot_f

        if self.h_update:
            h = self.node_net(torch.cat([h, tot_message], dim=-1))
        return x, v, h
