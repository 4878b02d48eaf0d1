"""The work the shares divide by (``h100_bench/counts``), against hand
counts at a small shape, and at EGNO's shape against the terms of the
repository's ``chip_smoke.py`` counts (written out here), with the two
changes the benchmark makes: the H x H products counted once, and the
backward without the forward it recomputes."""

import pytest

from h100_bench.counts import PEAKS, egno, pairwise, segno

EGNO_CFG = dict(num_timesteps=10, num_modes=2, n_balls=5, nf=64,
                in_edge_nf=2, in_node_nf=2, time_emb_dim=32, n_layers=4)
SEGNO_CFG = dict(num_timesteps=10, n_balls=5, nf=64, in_edge_nf=2,
                 in_node_nf=1)


def test_chain_counts_by_hand_at_a_small_shape():
    # H=2, E=1, one graph of N=3 with the 6 off-diagonal edges, K=1
    c = pairwise.Call(g=1, n=3, kept=6, h=2, e=1)
    # forward per edge: products a1 W2 and msg Wc1, 2 x 2 x 2 multiply-adds
    # = 16 FLOP; r2 wg 2, e We 2, ca wc2 2 multiply-adds = 12 FLOP; 12 a
    # hidden unit for the adds and three SiLUs = 24
    assert pairwise.fwd_products_per_edge(2) == 16
    assert pairwise.fwd_flops_per_edge(2, 1) == 16 + 12 + 24
    # weights: wg 2, We 2, b1 2, W2 4, b2 2, Wc1 4, bc1 2, wc2 2, bc2 1
    assert pairwise.weights(2, 1) == 21
    # x 9, hi 6, hj 6, e 9, mask 9, weights 21; tot_f 9, tot_m 6
    assert pairwise.fwd_bytes(c) == 4 * (9 + 6 + 6 + 9 + 9 + 21 + 9 + 6)
    # backward: the 4 H x H products 4 x 4 = 16 multiply-adds, 2EH + 2H = 8
    # more, 29H + 38 elementwise
    assert pairwise.bwd_products_per_edge(2) == 32
    assert pairwise.bwd_flops_per_edge(2, 1) == 2 * (16 + 4 + 4) + 58 + 38
    # the inputs and the cotangents (9 + 6) in; dx, dhi, dhj, de, dweights
    assert pairwise.bwd_bytes(c) == 4 * ((9 + 6 + 6 + 9 + 9 + 21 + 9 + 6)
                                         + (9 + 6 + 6 + 9 + 21))
    t, by = pairwise.bound_s(c)
    assert by == "bytes" and t == pytest.approx(
        pairwise.fwd_bytes(c) / PEAKS["hbm_bytes"])


def test_chain_counts_keep_chip_smokes_terms_at_egnos_shape():
    h, e = 64, 2
    smoke_fwd = 2 * (2 * h * h + h + e * h + h) + 12 * h
    smoke_bwd = 2 * (6 * h * h + 3 * e * h + 4 * h) + 41 * h + 38
    assert pairwise.fwd_flops_per_edge(h, e) == smoke_fwd
    assert pairwise.fwd_products_per_edge(h) == 2 * 2 * h * h   # once, not 3x
    # the backward leaves out the forward it recomputes
    assert pairwise.bwd_flops_per_edge(h, e) == smoke_bwd - smoke_fwd
    assert pairwise.bwd_products_per_edge(h) == 2 * 4 * h * h   # not 6 H^2
    g, n = 2560, 5
    c = pairwise.Call(g=g, n=n, kept=20, h=h, e=e)
    smoke_weights = 2 * h * h + 5 * h + e * h + 1
    smoke_in = g * n * 3 + g * n * h + g * n * h + g * n * n * e + n * n \
        + smoke_weights
    smoke_out = g * n * 3 + g * n * h
    assert pairwise.fwd_bytes(c) == 4 * (smoke_in + smoke_out)
    smoke_bwd_out = g * n * 3 + g * n * h + g * n * h + g * n * n * e \
        + smoke_weights
    assert pairwise.bwd_bytes(c) == 4 * (smoke_in + g * n * 3 + g * n * h
                                         + smoke_bwd_out)
    # K stacked weight sets over K x G graphs move what K calls move, but
    # for the mask, which they share and read once
    k5 = pairwise.Call(g=5 * g, n=n, kept=20, h=h, e=e, k=5)
    assert pairwise.fwd_bytes(k5) == 5 * pairwise.fwd_bytes(c) - 4 * 4 * n * n


def test_model_products_by_hand():
    # EGNO, one sample: T=2 frames of N=2 nodes (2 kept edges), H=2, E=1,
    # F=1, Ht=2, one layer, one mode
    cfg = dict(num_timesteps=2, num_modes=1, n_balls=2, nf=2, in_edge_nf=1,
               in_node_nf=1, time_emb_dim=2, n_layers=1)
    embed = 2 * 2 * (1 + 2) * 2
    spectral = 1 * 2 * (2 * 2 + 3 * 2 * 2) * 4
    frame = (2 * (1 + 1) * 2 + 2 * 2 * 2 * 2 + 2 * (2 * 2 * 2 + 2)
             + 2 * (2 * 2 + 2) + 2 * 3 * 2 * 2)
    assert egno.forward_flops(cfg, 3) == 2 * 3 * (embed + spectral
                                                  + 2 * frame)
    assert egno.train_flops(cfg, 3) == 3 * egno.forward_flops(cfg, 3)
    scfg = dict(num_timesteps=2, n_balls=2, nf=2, in_edge_nf=1,
                in_node_nf=1)
    step = 2 * 2 * 2 + 2 * 2 * 2 * 2 + 2 * (2 * 2 * 2 + 2) + 2 * 3 * 2 * 2
    assert segno.forward_flops(scfg, 1) == 2 * (2 * 1 * 2 + 2 * step)


def test_model_products_at_the_published_widths():
    # about 24.9 MFLOP an EGNO sample-forward, 5.4 SEGNO's (PERF.md)
    assert egno.forward_flops(EGNO_CFG, 1) == 24_904_960
    assert segno.forward_flops(SEGNO_CFG, 1) == 5_427_840
    calls = egno.pairwise_calls(EGNO_CFG, 256, k=5)
    assert calls == [(4, pairwise.Call(g=2560, n=5, kept=20, h=64, e=2,
                                       k=5))]
    assert segno.pairwise_calls(SEGNO_CFG, 1280, k=5) == [
        (10, pairwise.Call(g=1280, n=5, kept=20, h=64, e=2, k=5))]
