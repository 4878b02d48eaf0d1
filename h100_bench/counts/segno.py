"""SEGNO's useful products, counted as ``counts/egno.py`` counts EGNO's.
A forward of one sample is T steps of the weight-tied GCL on one graph of
N nodes with ``kept`` = N (N - 1) edges. Per sample: the embedding N F H;
per step the edge MLP's first layer with h_i and h_j projected once a
node, kept (1 + E) H + 2 N H^2; its second layer and the coordinate head,
kept (2 H^2 + H); the node MLP, N 3 H^2."""

from __future__ import annotations

from .pairwise import Call


def forward_flops(cfg, samples):
    n, h, e = cfg["n_balls"], cfg["nf"], cfg["in_edge_nf"]
    kept = n * (n - 1)
    step = (kept * (1 + e) * h + 2 * n * h * h + kept * (2 * h * h + h)
            + n * 3 * h * h)
    per_sample = n * cfg["in_node_nf"] * h + cfg["num_timesteps"] * step
    return 2 * samples * per_sample


def train_flops(cfg, samples):
    return 3 * forward_flops(cfg, samples)


def pairwise_calls(cfg, samples, k=1):
    """One call of the chain a step, over the batch's graphs."""
    n = cfg["n_balls"]
    return [(cfg["num_timesteps"], Call(g=samples, n=n, kept=n * (n - 1),
                                        h=cfg["nf"], e=cfg["in_edge_nf"],
                                        k=k))]
