"""SEGNO: Second-order Equivariant Graph Neural ODE (counterpart of
nonode_tpu/models/segno.py:35-202).

One shared SEGNOGCL applied T times as a weight-tied second-order
integrator with step 1/T (the live reference sets n_layers := T,
SEGNO/models/model.py:95-102). The JAX class's ``n_layers``, ``varDT``,
``coords_weight`` and ``edge_mask`` change no driver's run (no driver sets
the last two), so this class takes none of them. Several
input snapshots are integrated segment by segment and fused with the next
observation by sum or by invariant temporal attention (model.py:78-91).

As the JAX package documents (nonode_tpu/models/segno.py:9-19), the live
reference forward drops the last segment's integration; this class, like
the JAX one, integrates every segment, fuses between observations and
returns the last integrated state.

The JAX package's ``lax.scan`` over the steps is a Python loop here. Its
``integrate_masked`` runs ``max_interior`` steps and masks those past a
traced segment length; here segment lengths are host integers, so
``forward_dynamic`` runs exactly that many steps: the same values.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import Act, Linear, silu
from ..ops.dense_graph import SEGNOGCL
from ..runtime import resolve_device


class InvariantTemporalAttention(nn.Module):
    """Softmax-over-time weights from (|v|, h) (model.py:126-139), under the
    reference name ``attn_mlp.{0,2}``."""

    def __init__(self, in_dim: int, hidden_dim: int = 32, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.attn_mlp = nn.Sequential(Linear(in_dim + 1, hidden_dim, **kw),
                                      Act(torch.tanh),
                                      Linear(hidden_dim, 1, **kw))

    def forward(self, vel_seq, his_seq):
        """vel_seq: [L, ..., 3]; his_seq: [L, ..., F] -> weights [L, ..., 1]."""
        speed = torch.sqrt((vel_seq * vel_seq).sum(-1, keepdim=True))
        w = self.attn_mlp(torch.cat([speed, his_seq], dim=-1))
        return torch.softmax(w, dim=0)


class SEGNO(nn.Module):
    def __init__(self, in_node_nf: int = 1, in_edge_nf: int = 2,
                 hidden_nf: int = 64, recurrent: bool = True,
                 tanh: bool = False, multiple_agg: str | None = None, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.multiple_agg = multiple_agg
        kw = dict(device=device, generator=generator)
        self.embedding = Linear(in_node_nf, hidden_nf, **kw)
        self.module = SEGNOGCL(hidden_nf, in_edge_nf=in_edge_nf, act=silu,
                               recurrent=recurrent, tanh=tanh, **kw)
        if multiple_agg == "attn":
            self.enc_attn_net = InvariantTemporalAttention(hidden_nf,
                                                           hidden_nf, **kw)

    def integrate(self, h, x, v, edge_attr, steps: int, rows=None):
        """forward_step (model.py:95-102): ``steps`` GCL steps of 1/steps.
        Under a lower compute dtype the step is rounded to it first, as
        JAX's weak-typed ``1.0 / steps`` adopts a bf16 carry's dtype."""
        inv = 1.0 / steps
        if x.dtype != torch.float32:
            inv = torch.tensor(inv).to(x.dtype).item()
        for _ in range(steps):
            h, x, v = self.module(h, x, v, edge_attr, inv, rows=rows)
        return h, x, v

    def fuse(self, obs, pred):
        """Blend a predicted state (h, x, v) with the next observed one."""
        (ho, xo, vo), (hp, xp, vp) = obs, pred
        if self.multiple_agg == "sum":
            return ho + hp, xo + xp, vo + vp
        if self.multiple_agg == "attn":
            hs = torch.stack([ho, hp])
            xs = torch.stack([xo, xp])
            vs = torch.stack([vo, vp])
            w = self.enc_attn_net(vs, hs)
            return (w * hs).sum(0), (w * xs).sum(0), (w * vs).sum(0)
        raise ValueError(f"Invalid multiple_agg: {self.multiple_agg}")

    def _segments(self, his, x, v, edge_attr, steps, rows):
        """Integrate ``steps[i]`` steps from snapshot 0, fusing with snapshot
        i + 1 after each segment but the last. his/x/v: [L, B, N, .]."""
        h = self.embedding(his)                          # [L, B, N, H]
        h_, x_, v_ = h[0], x[0], v[0]
        last = len(steps) - 1
        for i, step in enumerate(steps):
            state = self.integrate(h_, x_, v_, edge_attr, step, rows)
            h_, x_, v_ = (state if i == last else
                          self.fuse((h[i + 1], x[i + 1], v[i + 1]), state))
        return x_, h_, v_

    def forward(self, his, x, v, edge_attr, T: int = 10, in_steps=None,
                rows=None):
        """Predict the state T integrator steps ahead.

        Single input: his [B, N, F]; x, v [B, N, 3]; edge_attr [B, N, N, E].
        Several inputs: a leading L axis on his/x/v, and ``in_steps`` the
        input frame offsets; segment lengths are diff(in_steps) + [T]
        (model.py:71). ``rows`` (ops.dense_graph.ReceiverRows): the node
        tensors hold the receivers [i0, i0 + ni) and edge_attr [.., ni, N,
        E]; the fusion of inputs is per node. Returns (x, h, v), each
        [B, N, .].
        """
        if x.dim() == 4:                                 # [L, B, N, 3]
            if in_steps is None:
                raise ValueError("several inputs need in_steps")
            steps = [int(b) - int(a)
                     for a, b in zip(in_steps[:-1], in_steps[1:])] + [T]
        else:
            his, x, v = his[None], x[None], v[None]
            steps = [T]
        return self._segments(his, x, v, edge_attr, steps, rows)

    def forward_dynamic(self, his, x, v, edge_attr, seg_lens, T: int = 10):
        """Several inputs with per-batch segment lengths: his/x/v
        [L, B, N, .]; ``seg_lens`` the L-1 host integers diff(input frames);
        the last segment is T. Returns (x, h, v) as ``forward``."""
        if x.shape[0] < 2 or len(seg_lens) != x.shape[0] - 1:
            raise ValueError(f"{x.shape[0]} snapshots need "
                             f"{x.shape[0] - 1} segment lengths, got "
                             f"{len(seg_lens)}")
        steps = [int(s) for s in seg_lens] + [T]
        return self._segments(his, x, v, edge_attr, steps, None)
