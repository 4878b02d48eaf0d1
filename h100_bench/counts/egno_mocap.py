"""EGNO's useful products on the mocap graph, counted as ``counts/egno.py``
counts them on a complete one, and the chain's calls. A forward of one
sample decodes T frames; each frame is a graph of N = ``n_node`` joints
whose edges are the kept pairs of the skeleton + 2-hop mask, ``kept`` =
``mask_pairs`` (130 of CMU's 31 joints), from the configuration's mask and
never from what the program launches. Per sample:

- the embedding: T N (F + Ht) H;
- per layer, the spectral convolutions' mode products: modes N H^2 4 on h
  and modes N 3 (2 x 2) 4 on (x - mean x, v);
- per layer and frame, the edge MLP's first layer over the kept edges
  with h_i and h_j projected once a node, kept (1 + E) H + 2 N H^2; its
  second layer and the coordinate head, kept (2 H^2 + H); the velocity
  gate, N (H^2 + H); the node MLP, N 3 H^2.

A training step's backward is twice the forward's products."""

from __future__ import annotations

from .egno import _modes
from .pairwise import Call


def forward_flops(cfg, samples):
    """FLOP of the products of a forward over ``samples`` samples."""
    t, n, h = cfg["num_timesteps"], cfg["n_node"], cfg["nf"]
    e, kept = cfg["in_edge_nf"], cfg["mask_pairs"]
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
    """[(calls, Call)] of the chain in a forward over ``samples`` samples:
    one call a layer over every frame's graph, G = T B."""
    return [(cfg["n_layers"], Call(g=samples * cfg["num_timesteps"],
                                   n=cfg["n_node"], kept=cfg["mask_pairs"],
                                   h=cfg["nf"], e=cfg["in_edge_nf"], k=k))]
