"""Why the pairwise-chain kernels take their products in split TF32.

The CUDA kernels (nonode_tpu_torch/csrc/egnn_fused_fwd.cu, egnn_fused_bwd.cu,
egnn_tf32.cuh) run the chain's HxH products on the tensor cores in TF32,
which keeps 10 mantissa bits. Each fp32 operand is written as big + small,
both rounded to TF32 with cvt.rna (round to nearest, ties away from zero),
small from the fp32 difference a - big, and a product is the fp32 sum of
small*big' + big*small' + big*big', taken 8 terms of the contraction at a time
(one m16n16k8 step) in that order. This file emulates that rounding on the
CPU at the kernels' shapes (rows x 64 @ 64 x 64, and the weight gradients'
64 x rows @ rows x 64), with the weights and activation scales of
chip_smoke.pairwise_inputs, and holds it to a float64 product: split TF32
stays within 1e-5 x max(1, max|ref|), the kernels' fp32-parity budget, and a
single TF32 pass does not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke

H = 64
TOL = 1e-5
K_STEP = 8       # the contraction depth of one m16n16k8 tensor-core step


def to_tf32(t):
    """cvt.rna.tf32.f32 on the fp32 bits: keep 10 mantissa bits, rounding the
    magnitude to nearest with ties away from zero (finite inputs)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    out = sign | mag
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def split(t):
    big = to_tf32(t)
    return big, to_tf32(t - big)


def tc_product(a, b, passes):
    """a @ b as the kernels' tensor-core loop takes it: fp32 accumulation, one
    8-deep step at a time. A product of two TF32 values is exact in fp32, so
    each step's 8-term fp32 sum stands for the MMA's."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], K_STEP):
        ak, bk = a[:, k:k + K_STEP], b[k:k + K_STEP]
        if passes == 3:
            (a_big, a_small), (b_big, b_small) = split(ak), split(bk)
            acc = acc + a_small @ b_big
            acc = acc + a_big @ b_small
            acc = acc + a_big @ b_big
        else:
            acc = acc + to_tf32(ak) @ to_tf32(bk)
    return acc


def chain_products(scale):
    """The six products of the chain's forward and backward, (a, b) pairs in
    fp32, from the slice's inputs on 32 graphs of N = 5 (800 edge rows); hi
    and hj multiplied by ``scale``."""
    g, n, e = 32, 5, 2
    x, hi, hj, efea, mask, weights = chip_smoke.pairwise_inputs(
        g, n, H, e, seed=n, dev="cpu")
    hi, hj = hi * scale, hj * scale
    wg, we, b1, w2, b2, wc1, bc1, wc2, bc2 = weights
    rows = lambda t: t.reshape(-1, t.shape[-1])               # noqa: E731
    rij = x[:, :, None, :] - x[:, None, :, :]
    r2 = (rij * rij).sum(-1, keepdim=True)
    pre1 = r2 * wg + efea @ we + hi[:, :, None, :] + hj[:, None, :, :] + b1
    a1 = rows(F.silu(pre1))
    pre2 = a1 @ w2 + b2
    msg = F.silu(pre2)
    cpre = msg @ wc1 + bc1
    rng = np.random.RandomState(0)
    gtotf, gtotm = (torch.tensor(rng.randn(*s), dtype=torch.float32)
                    for s in ((g, n, 3), (g, n, H)))
    gf = rows((gtotf[:, :, None, :] * (mask / mask.sum(-1, keepdim=True))
               [..., None]))
    dcw = (gf * rows(rij)).sum(-1, keepdim=True)
    s = torch.sigmoid(cpre)
    dcpre = dcw * wc2.T * s * (1 + cpre * (1 - s))
    s = torch.sigmoid(pre2)
    dpre2 = ((dcpre @ wc1.T + rows(gtotm[:, :, None, :] * mask[..., None]))
             * s * (1 + pre2 * (1 - s)))
    return {"a1 @ W2": (a1, w2), "msg @ Wc1": (msg, wc1),
            "dcpre @ Wc1^T": (dcpre, wc1.T), "dpre2 @ W2^T": (dpre2, w2.T),
            "a1^T dpre2": (a1.T, dpre2), "msg^T dcpre": (msg.T, dcpre)}


PRODUCTS = ("a1 @ W2", "msg @ Wc1", "dcpre @ Wc1^T", "dpre2 @ W2^T",
            "a1^T dpre2", "msg^T dcpre")


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10                  # TF32's spacing just above 1
    got = to_tf32(torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                                1 + 3 * ulp / 4, 3.0, -0.0, 1e-30],
                               dtype=torch.float32))
    assert got.tolist()[:5] == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0]
    assert got[5].item() == 0.0 and got[6].item() != 0.0
    # rounded values keep 10 mantissa bits; big + small recovers a to ~2^-22
    a = torch.tensor(np.random.RandomState(1).randn(4096), dtype=torch.float32)
    big, small = split(a)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    assert float(((big.double() + small.double() - a.double()).abs()
                  / a.double().abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("scale", [1.0, 200.0],
                         ids=["slice", "activations x200"])
@pytest.mark.parametrize("name", PRODUCTS)
def test_split_tf32_meets_the_fp32_budget_and_one_pass_does_not(name, scale):
    a, b = chain_products(scale)[name]
    ref = a.double() @ b.double()
    bound = TOL * max(1.0, float(ref.abs().max()))
    split_err = float((tc_product(a, b, 3).double() - ref).abs().max())
    single_err = float((tc_product(a, b, 1).double() - ref).abs().max())
    assert split_err <= bound, (split_err, bound)
    assert single_err > bound, (single_err, bound)
