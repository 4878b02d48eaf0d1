"""Operations and bytes of one call of the pairwise-message chain of an
EGNN layer or SEGNO step (the program's kernels #1 and #2), and the least
time any float32-class implementation can take for it.

Per kept edge (i, j) of each graph, with H hidden units and E edge
features:

    pre1  = r2 wg + e We + b1 + h_i + h_j
    msg   = silu(silu(pre1) W2 + b2)
    cw    = silu(msg Wc1 + bc1) wc2 + bc2
    tot_f = mean_j (x_i - x_j) cw,  tot_m = sum_j msg

The forward's FLOP per edge are the repository's ``chip_smoke.py``
``pairwise_flops_per_edge``: 2 (2H^2 + H + EH + H) + 12H, the two H x H
products a1 W2 and msg Wc1 among them (2H^2 multiply-adds). The
backward's are its ``pairwise_bwd_flops_per_edge``, 2 (6H^2 + 3EH + 4H) +
41H + 38, less the forward it recomputes: 2 (4H^2 + 2EH + 2H) + 29H + 38,
whose H x H products are 4H^2 multiply-adds (dcpre Wc1^T, dpre2 W2^T,
a1^T dpre2, msg^T dcpre). Bytes are ``chip_smoke.py``'s
``pairwise_bytes``: each input read once and each output written once,
with K weight sets (and their gradients) where the call stacks K.

The bound is the longest of three times, which together bound every
float32-class route: the H x H products, each counted once, at the TF32
tensor-core peak; the other FLOP at the float32 CUDA-core peak; the bytes
at the HBM rate."""

from __future__ import annotations

import dataclasses

from . import PEAKS


@dataclasses.dataclass(frozen=True)
class Call:
    """The shapes of a call: G graphs of N nodes, ``kept`` edges of the
    [N, N] mask a graph, H hidden units, E edge features, K weight sets
    (G = K x B)."""

    g: int
    n: int
    kept: int
    h: int
    e: int
    k: int = 1

    @property
    def edges(self) -> int:
        return self.g * self.kept


def fwd_flops_per_edge(h, e):
    return 2 * (2 * h * h + h + e * h + h) + 12 * h


def fwd_products_per_edge(h):
    return 2 * (2 * h * h)


def bwd_flops_per_edge(h, e):
    return 2 * (4 * h * h + 2 * e * h + 2 * h) + 29 * h + 38


def bwd_products_per_edge(h):
    return 2 * (4 * h * h)


def weights(h, e):
    """Floats of one weight set: wg, We, b1, W2, b2, Wc1, bc1, wc2, bc2."""
    return 2 * h * h + 5 * h + e * h + 1


def fwd_bytes(c: Call):
    inputs = (c.g * c.n * 3 + 2 * c.g * c.n * c.h + c.g * c.n * c.n * c.e
              + c.n * c.n + c.k * weights(c.h, c.e))
    outputs = c.g * c.n * 3 + c.g * c.n * c.h
    return 4 * (inputs + outputs)


def bwd_bytes(c: Call):
    inputs = (c.g * c.n * 3 + 2 * c.g * c.n * c.h + c.g * c.n * c.n * c.e
              + c.n * c.n + c.k * weights(c.h, c.e)
              + c.g * c.n * 3 + c.g * c.n * c.h)          # the cotangents
    outputs = (c.g * c.n * 3 + 2 * c.g * c.n * c.h + c.g * c.n * c.n * c.e
               + c.k * weights(c.h, c.e))
    return 4 * (inputs + outputs)


def bound_s(c: Call, backward=False):
    """(seconds, what sets them) of the least time for the call."""
    if backward:
        products = c.edges * bwd_products_per_edge(c.h)
        rest = c.edges * bwd_flops_per_edge(c.h, c.e) - products
        nbytes = bwd_bytes(c)
    else:
        products = c.edges * fwd_products_per_edge(c.h)
        rest = c.edges * fwd_flops_per_edge(c.h, c.e) - products
        nbytes = fwd_bytes(c)
    times = {"tensor cores": products / PEAKS["tf32_flops"],
             "CUDA cores": rest / PEAKS["fp32_flops"],
             "bytes": nbytes / PEAKS["hbm_bytes"]}
    by = max(times, key=times.get)
    return times[by], by
