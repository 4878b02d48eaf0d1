"""EGNO's useful products: the multiply-adds of its matrix products, two
FLOP each, from the configuration's shapes. Elementwise work (the
activations, the FFTs, the sums over edges) is left out, and so is
anything an implementation recomputes.

A forward of one sample decodes T frames; each frame is a graph of N
nodes with ``kept`` = N (N - 1) edges. Per sample:

- the embedding: T N (F + Ht) H;
- per layer, the spectral convolutions' mode products, four real
  multiply-adds a complex one: modes N H^2 4 on h and modes N 3 (2 x 2) 4
  on (x - mean x, v);
- per layer and frame, the edge MLP's first layer over the kept edges,
  with h_i and h_j projected once a node: kept (1 + E) H + 2 N H^2; its
  second layer and the coordinate head: kept (2 H^2 + H); the velocity
  gate: N (H^2 + H); the node MLP: N 3 H^2.

A training step's backward is twice the forward's products."""

from __future__ import annotations

from .pairwise import Call


def _modes(cfg):
    t, m = cfg["num_timesteps"], cfg["num_modes"]
    return min(m, 3) if t == 5 else min(t, m)


def forward_flops(cfg, samples):
    """FLOP of the products of a forward over ``samples`` samples."""
    t, n, h = cfg["num_timesteps"], cfg["n_balls"], cfg["nf"]
    e, kept = cfg["in_edge_nf"], n * (n - 1)
    embed = t * n * (cfg["in_node_nf"] + cfg["time_emb_dim"]) * h
    spectral = _modes(cfg) * n * (h * h + 3 * 2 * 2) * 4
    frame = (kept * (1 + e) * h + 2 * n * h * h + kept * (2 * h * h + h)
             + n * (h * h + h) + n * 3 * h * h)
    per_sample = embed + cfg["n_layers"] * (spectral + t * frame)
    return 2 * samples * per_sample


def train_flops(cfg, samples):
    """A training step over ``samples`` samples: the forward and twice
    its products for the backward."""
    return 3 * forward_flops(cfg, samples)


def pairwise_calls(cfg, samples, k=1):
    """[(calls, Call)] of the chain in a forward over ``samples`` samples
    (with ``k`` weight sets): one call a layer over every frame's graph."""
    n = cfg["n_balls"]
    return [(cfg["n_layers"], Call(g=samples * cfg["num_timesteps"], n=n,
                                   kept=n * (n - 1), h=cfg["nf"],
                                   e=cfg["in_edge_nf"], k=k))]
