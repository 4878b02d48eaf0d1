"""Linear and MLP with the reference's state_dict names and init bounds.

Counterpart of nonode_tpu/nn.py. ``Linear`` keeps torch's ``[out, in]``
layout and its default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) bounds for weight
and bias; ``MLP`` keeps the reference BaseMLP's switches that EGNO uses
(last_act, flat = tanh and 4x hidden) under ``mlp.{0,2}`` names.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def silu(x):
    return F.silu(x)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def uniform(shape, low, high, generator=None, device=None):
    """U(low, high) drawn on the CPU from ``generator``, then moved, so that
    a seed gives the same weights on every device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (low + (high - low) * u).to(device)


def xavier_uniform(shape, gain=1.0, generator=None, device=None):
    """torch.nn.init.xavier_uniform_ for an [out, in] weight, drawn as
    ``uniform`` draws (nonode_tpu/nn.py:xavier_uniform_init)."""
    fan_out, fan_in = shape
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(shape, -bound, bound, generator, device)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, device=None,
                 generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.weight = nn.Parameter(
            uniform((out_dim, in_dim), -bound, bound, generator, device))
        self.bias = nn.Parameter(
            uniform((out_dim,), -bound, bound, generator, device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Act(nn.Module):
    """A parameter-free activation slot, so Linear layers sit at
    ``mlp.0`` / ``mlp.2`` as in the reference nn.Sequential."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class MLP(nn.Module):
    """Two-layer MLP with the reference BaseMLP's exact switches."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 act: Callable = silu, last_act: bool = False,
                 flat: bool = False, *, device=None, generator=None):
        super().__init__()
        hidden = 4 * hidden_dim if flat else hidden_dim
        self.act = torch.tanh if flat else act
        self.last_act = last_act
        layers = [Linear(in_dim, hidden, device=device, generator=generator),
                  Act(self.act),
                  Linear(hidden, out_dim, device=device, generator=generator)]
        if last_act:
            layers.append(Act(self.act))
        self.mlp = nn.Sequential(*layers)

    def forward(self, x):
        return self.mlp(x)

    def from_preact(self, pre):
        """Finish the MLP from a precomputed first-layer pre-activation
        (see ops.dense_graph.first_edge_linear)."""
        y = self.mlp[2](self.act(pre))
        return self.act(y) if self.last_act else y
