"""Dense pairwise graph ops, the EGNN layer and SEGNO's GCL (counterpart of
nonode_tpu/ops/dense_graph.py:32-365).

Fully connected graphs are dense ``[..., N, N, .]`` tensors with an
off-diagonal mask; edge (i, j) carries the message node i receives from
node j. Aggregation is a masked sum or mean over j.

With the particle axis sharded (``ReceiverRows``), a layer holds the
receivers [i0, i0 + ni) of each graph: its node tensors are [..., ni, .],
its edge tensors [..., ni, N, .] against all N senders, whose positions and
features come through ``rows.gather``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from ..nn import MLP, Act, Linear, silu, xavier_uniform
from ..utils.profiling import span
from .kernels import egnn_fused


@dataclasses.dataclass(frozen=True)
class ReceiverRows:
    """The receiver rows [i0, i0 + ni) of a graph's ``n`` nodes that a rank
    holds (parallel/mesh.py). ``gather`` makes a [..., ni, F] node tensor
    the [..., n, F] one of all senders; its backward sums the gradient over
    the ranks that share the graph and keeps the rows. ``node_sum`` sums a
    tensor over those ranks (a reduction over the particle axis)."""

    i0: int
    n: int
    gather: Callable
    node_sum: Callable


def offdiag_mask(n: int, dtype=torch.float32, device=None, i0: int = 0,
                 ni: int | None = None):
    """[ni, N] mask that zeroes self-edges: rows [i0, i0 + ni) of the [N, N]
    one (all of them by default), the diagonal at column i0 + i."""
    mask = 1.0 - torch.eye(n, dtype=dtype, device=device)
    return mask if ni is None else mask[i0:i0 + ni]


def sender_view(x, h, rows: ReceiverRows | None):
    """(senders' x, senders' h, N, i0) of a layer's receivers x, h: the
    tensors themselves on a whole graph, gathered on a receiver slice."""
    if rows is None:
        return x, h, x.shape[-2], 0
    return rows.gather(x), rows.gather(h), rows.n, rows.i0


def pairwise_diff(x, xs=None):
    """x: [..., N, D] -> r[..., i, j, :] = x_i - x_j; with the senders
    ``xs`` [..., N, D], x holds receivers [..., ni, D] -> [..., ni, N, D]."""
    xs = x if xs is None else xs
    return x[..., :, None, :] - xs[..., None, :, :]


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


def fused_chain(clip_edges, x, h, edge_fea, mask, l1, l2, c1, c2,
                radial_col, hi_col, xs=None, hs=None, i0=0):
    """(tot_f, tot_m) of a layer's pairwise chain through the fused kernels
    (ops.kernels.egnn_fused). ``l1``, ``l2`` are the edge MLP's Linears and
    ``c1``, ``c2`` the coordinate head's; the first edge Linear's columns
    hold the radial at ``radial_col``, h_i and h_j from ``hi_col`` (H each)
    and the edge features last. Leading dims flatten to one graph axis, and
    the h_i / h_j column slices are projected per node here (as
    first_edge_linear does). The nine weights are slices, transposes and row
    views of the Linear parameters, so the backward's weight gradients reach
    them through autograd. ``xs``, ``hs``: all N senders' positions and
    features when x, h hold the receivers [i0, i0 + ni) (default: x, h)."""
    xs = x if xs is None else xs
    hs = h if hs is None else hs
    hdim = l1.weight.shape[0]
    e = edge_fea.shape[-1]
    lead = x.shape[:-2]
    ni, n = x.shape[-2], xs.shape[-2]
    g = 1
    for d in lead:
        g *= d
    w1 = l1.weight
    hi = h @ w1[:, hi_col:hi_col + hdim].T
    hj = hs @ w1[:, hi_col + hdim:hi_col + 2 * hdim].T
    weights = (w1[:, radial_col:radial_col + 1].T, w1[:, w1.shape[1] - e:].T,
               l1.bias[None, :], l2.weight.T, l2.bias[None, :],
               c1.weight.T, c1.bias[None, :],
               c2.weight.T, c2.bias[None, :])            # wc2 [H,1], bc2 [1,1]
    ef = edge_fea.expand(*lead, ni, n, e)
    tot_f, tot_m = egnn_fused.pairwise_message(
        clip_edges,
        xs.reshape(g, n, 3).contiguous(), hi.reshape(g, ni, hdim).contiguous(),
        hj.reshape(g, n, hdim).contiguous(),
        ef.reshape(g, ni, n, e).contiguous(), mask.contiguous(), weights, i0)
    return tot_f.reshape(*lead, ni, 3), tot_m.reshape(*lead, ni, hdim)


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

    def _use_fused(self, x, edge_mask, n=None) -> bool:
        """Whether the fused chain takes the layer's graphs of ``n`` nodes
        (default: x's)."""
        n = x.shape[-2] if n is None else n
        return (self.fused and self.in_edge_nf >= 1
                and (edge_mask is None or edge_mask.dim() == 2)
                and egnn_fused.supported(n, self.hidden_nf, x.dtype,
                                         self.act, self.flat, self.norm))

    def forward(self, x, h, edge_fea, v=None, edge_mask=None, rows=None):
        """x: [..., N, 3]; h: [..., N, H]; edge_fea: [..., N, N, E].

        edge_mask: optional [..., N, N] 0/1 mask restricting the graph;
        defaults to the complete graph. ``rows`` (ReceiverRows): x, h hold
        the receivers [i0, i0 + ni) and edge_fea [..., ni, N, E]."""
        with span("egnn.layer"):
            ni = x.shape[-2]
            xs, hs, n, i0 = sender_view(x, h, rows)
            mask = offdiag_mask(n, x.dtype, x.device, i0,
                                None if rows is None else ni)
            if edge_mask is not None:
                mask = mask * edge_mask[..., i0:i0 + ni, :]

            if self._use_fused(x, edge_mask, n):
                # the edge MLP's input order: [||r_ij||^2, h_i, h_j, edge_fea]
                tot_f, tot_message = fused_chain(
                    False, x, h, edge_fea, mask, self.edge_net.mlp[0],
                    self.edge_net.mlp[2], self.coord_net.mlp[0],
                    self.coord_net.mlp[2], radial_col=0, hi_col=1, xs=xs,
                    hs=hs, i0=i0)
            else:
                rij = pairwise_diff(x, xs)
                r2 = (rij * rij).sum(dim=-1, keepdim=True)
                gram = _l2_normalize(r2) if self.norm else r2
                pre = first_edge_linear(
                    self.edge_net.mlp[0],
                    [(gram, "pair"), (h, "i"), (hs, "j"), (edge_fea, "pair")])
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


class SEGNOGCL(nn.Module):
    """Dense second-order equivariant GCL, one integrator step of SEGNO
    (counterpart of nonode_tpu/ops/dense_graph.py:SEGNOGCL, SEGNO_GCL in
    SEGNO/models/models/gcl.py:26-119).

    Edge MLP on [h_i, h_j, ||r_ij||^2, edge_attr], both layers activated;
    the coordinate head gives a per-edge scalar times r_ij, clipped to +-100
    per edge before the masked mean (no clip after the mean, unlike
    EGNNLayer), times ``coords_weight``; the second-order update
    ``v += agg / T; x += v / T``; the node MLP on [h, sum_j edge_feat],
    residual when ``recurrent``. Module names follow the reference
    state_dict (``edge_mlp``, ``node_mlp``, ``coord_mlp``).

    ``fused`` routes the pairwise chain through ops.kernels.egnn_fused with
    ``clip_edges=True`` when the config passes its gate (the CUDA kernels on
    the card, their plain versions on the CPU); otherwise, as with
    ``tanh=True``, the dense path runs.
    """

    # not a parameter: the reference's nn.Parameter(torch.ones(1)) * 3
    # (gcl.py:59) is an unregistered product, never in the state_dict
    COORDS_RANGE = 3.0

    def __init__(self, hidden_nf: int, in_edge_nf: int = 0,
                 act: Callable = silu, recurrent: bool = True,
                 coords_weight: float = 1.0, tanh: bool = False,
                 fused: bool = True, *, device=None, generator=None):
        super().__init__()
        self.hidden_nf = hidden_nf
        self.in_edge_nf = in_edge_nf
        self.act = act
        self.recurrent = recurrent
        self.coords_weight = coords_weight
        self.tanh = tanh
        self.fused = fused
        kw = dict(device=device, generator=generator)
        h = hidden_nf
        self.edge_mlp = nn.Sequential(
            Linear(2 * h + 1 + in_edge_nf, h, **kw), Act(act),
            Linear(h, h, **kw), Act(act))
        self.node_mlp = nn.Sequential(Linear(2 * h, h, **kw), Act(act),
                                      Linear(h, h, **kw))
        head = Linear(h, 1, **kw)
        # the reference's xavier_uniform_(gain=0.001) on the last coordinate
        # layer (gcl.py:50-51); its bias keeps the Linear init
        with torch.no_grad():
            head.weight.copy_(xavier_uniform((1, h), 0.001, **kw))
        self.coord_mlp = nn.Sequential(Linear(h, h, **kw), Act(act), head)

    def _coord_head(self, edge_feat):
        y = self.coord_mlp(edge_feat)
        if self.tanh:
            y = torch.tanh(y) * self.COORDS_RANGE
        return y

    def _use_fused(self, x, edge_attr, n=None) -> bool:
        """As EGNNLayer._use_fused."""
        n = x.shape[-2] if n is None else n
        return (self.fused and self.in_edge_nf >= 1 and edge_attr is not None
                and egnn_fused.supported(n, self.hidden_nf, x.dtype,
                                         self.act, False, False,
                                         tanh=self.tanh))

    def forward(self, h, x, v, edge_attr, inv_steps: float, rows=None):
        """One integrator step on the complete graph; inv_steps = 1/T.
        h: [..., N, H]; x, v: [..., N, 3]; edge_attr: [..., N, N, E] or None.
        ``rows`` (ReceiverRows): h, x, v hold the receivers [i0, i0 + ni)
        and edge_attr [..., ni, N, E]. Returns (h, x, v)."""
        with span("segno.gcl"):
            ni = x.shape[-2]
            xs, hs, n, i0 = sender_view(x, h, rows)
            mask = offdiag_mask(n, x.dtype, x.device, i0,
                                None if rows is None else ni)
            if self._use_fused(x, edge_attr, n):
                tot_trans, msg = fused_chain(
                    True, x, h, edge_attr, mask, self.edge_mlp[0],
                    self.edge_mlp[2], self.coord_mlp[0], self.coord_mlp[2],
                    radial_col=2 * self.hidden_nf, hi_col=0, xs=xs, hs=hs,
                    i0=i0)
                agg = tot_trans * self.coords_weight
            else:
                rij = pairwise_diff(x, xs)
                radial = (rij * rij).sum(dim=-1, keepdim=True)
                segs = [(h, "i"), (hs, "j"), (radial, "pair")]
                if edge_attr is not None and self.in_edge_nf:
                    segs.append((edge_attr, "pair"))
                pre = first_edge_linear(self.edge_mlp[0], segs)
                edge_feat = self.act(self.edge_mlp[2](self.act(pre)))
                trans = (rij * self._coord_head(edge_feat)).clamp(-100.0,
                                                                  100.0)
                agg = masked_mean_j(trans, mask) * self.coords_weight
                msg = masked_sum_j(edge_feat, mask)

            v = v + agg * inv_steps
            x = x + v * inv_steps
            out = self.node_mlp(torch.cat([h, msg], dim=-1))
            h = h + out if self.recurrent else out
            return h, x, v
