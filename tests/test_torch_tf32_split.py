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
single TF32 pass does not. The same holds at the tile routes' widths (H =
256 and 1024), where a product's K steps over H: the budget the card's
cases there are held to. #1's tile route reads W2 and Wc1 as slabs that a
split pass writes once a call, in wgmma's shared-memory layout
(csrc/egnn_wgmma.cuh): the last tests rebuild a product from that layout,
read as the descriptors read it, and hold it to the same budget.
"""

import re
from pathlib import Path

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


def chain_products(scale, h=H, g=32):
    """The six products of the chain's forward and backward, (a, b) pairs in
    fp32, from the slice's inputs on g graphs of N = 5 (25 g edge rows) at
    width ``h``; hi and hj multiplied by ``scale``."""
    n, e = 5, 2
    x, hi, hj, efea, mask, weights = chip_smoke.pairwise_inputs(
        g, n, h, e, seed=n, dev="cpu")
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
                    for s in ((g, n, 3), (g, n, h)))
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


@pytest.mark.parametrize("h", [256, 1024])
@pytest.mark.parametrize("name", PRODUCTS)
def test_split_tf32_meets_the_fp32_budget_at_the_wide_widths(name, h):
    """The wide route's products (K = H = 256 and 1024 in the HxH products,
    K = 200 edge rows in the weight gradients, more than a tile's 128)
    within the same budget, and a single TF32 pass outside it: the whole
    contraction, over one column pass (64 output columns) of each."""
    a, b = chain_products(1.0, h, g=8)[name]
    b = b[:, :64]
    ref = a.double() @ b.double()
    bound = TOL * max(1.0, float(ref.abs().max()))
    split_err = float((tc_product(a, b, 3).double() - ref).abs().max())
    single_err = float((tc_product(a, b, 1).double() - ref).abs().max())
    assert split_err <= bound, (split_err, bound)
    assert single_err > bound, (single_err, bound)


def chain_tot_f(x, hi, hj, efea, mask, weights, product):
    """The chain's tot_f with its two HxH products taken by ``product``."""
    wg, we, b1, w2, b2, wc1, bc1, wc2, bc2 = weights
    rij = x[:, :, None, :] - x[:, None, :, :]
    r2 = (rij * rij).sum(-1, keepdim=True)
    pre1 = r2 * wg + efea @ we + hi[:, :, None, :] + hj[:, None, :, :] + b1
    g, n, _, h = pre1.shape
    msg = F.silu(product(F.silu(pre1).reshape(-1, h), w2) + b2)
    cw = F.silu(product(msg, wc1) + bc1) @ wc2 + bc2
    f = rij * cw.reshape(g, n, n, 1)
    deg = mask.sum(-1, keepdim=True).clamp(min=1.0)
    return (f * mask[..., None]).sum(-2) / deg


@pytest.mark.parametrize("h", [64, 256, 1024])
def test_split_tf32_chain_meets_the_budget_at_every_width(h):
    """The whole forward chain to tot_f, its products in split TF32 with
    the accumulation rounded to nearest, against the fp32 plain version:
    within the budget at every width, the depth of the contraction
    notwithstanding (what the wide route's chunked accumulation keeps on
    the card, csrc/egnn_wide.cuh: each 64-deep chunk of K from zero)."""
    inputs = chip_smoke.pairwise_inputs(32, 5, h, 2, seed=5, dev="cpu")
    plain = chain_tot_f(*inputs, lambda a, b: a @ b)
    split = chain_tot_f(*inputs, lambda a, b: tc_product(a, b, 3))
    bound = TOL * max(1.0, float(plain.abs().max()))
    assert float((split - plain).abs().max()) <= bound


WGMMA_HEADER = Path(__file__).resolve().parents[1] / "nonode_tpu_torch" / \
    "csrc" / "egnn_wgmma.cuh"


def slab_constants():
    """kPanel, kLbo, kSbo and kStepBytes as csrc/egnn_wgmma.cuh defines
    them."""
    text = WGMMA_HEADER.read_text()
    out = {}
    for name in ("kPanel", "kLbo", "kSbo", "kStepBytes"):
        m = re.search(rf"constexpr \w+ {name} = ([^;]+);", text)
        out[name] = eval(m.group(1), {}, dict(out))
    return out


def fwd_slabs(w, hp):
    """One weight [h][h] ([in][out]) as #1's split pass (egnn_fwd_split)
    writes it at padded width hp: slab (pass, chunk) at pass * NP + chunk,
    its big part then its small part, element (n, k) of B(k, n) =
    W[64 chunk + k][64 pass + n] at ((n / 8) * 16 + k / 4) * 32 + (n % 8) *
    4 + k % 4; zero from row or column h."""
    c = slab_constants()
    panel = c["kPanel"]
    np_ = hp // panel
    h = w.shape[0]
    wp = torch.zeros(hp, hp)
    wp[:h, :h] = w
    f = torch.arange(hp * hp)
    slab, within = f // (panel * panel), f % (panel * panel)
    pas, chunk = slab // np_, slab % np_
    cm = within >> 5
    n = (cm >> 4) * 8 + ((within & 31) >> 2)
    k = (cm & 15) * 4 + (within & 3)
    big, small = split(wp[chunk * panel + k, pas * panel + n])
    out = torch.zeros(np_ * np_, 2, panel * panel)
    out[slab, 0, within] = big
    out[slab, 1, within] = small
    return out


def descriptor_read(part, ks):
    """B(k, n), k < 8 and n < 64, of k step ks of one slab part, read as
    wgmma reads a K-major operand without swizzle through slab_desc: the
    start advanced ks x kStepBytes; core matrices of 8 rows n and 16 bytes
    (4 k each), the two along k kLbo bytes apart, the 8-row groups along n
    kSbo bytes apart."""
    c = slab_constants()
    n = torch.arange(c["kPanel"])[None, :]
    k = torch.arange(8)[:, None]
    byte = (ks * c["kStepBytes"] + (n // 8) * c["kSbo"] + (n % 8) * 16
            + (k // 4) * c["kLbo"] + (k % 4) * 4)
    return part[byte // 4]


def slab_product(a, slabs, hp):
    """a @ W over every pass as #1's tile route takes it from the slabs:
    per 64-column pass, each 64-deep chunk of K from zero in 8-deep steps
    (small * big, big * small, big * big), the chunks added in fp32."""
    panel = slab_constants()["kPanel"]
    np_ = hp // panel
    ap = torch.zeros(a.shape[0], hp)
    ap[:, :a.shape[1]] = a
    out = torch.zeros(a.shape[0], hp)
    for pas in range(np_):
        run = torch.zeros(a.shape[0], panel)
        for chunk in range(np_):
            part = torch.zeros(a.shape[0], panel)
            for ks in range(8):
                k0 = chunk * panel + 8 * ks
                a_big, a_small = split(ap[:, k0:k0 + 8])
                slab = slabs[pas * np_ + chunk]
                b_big = descriptor_read(slab[0], ks)
                b_small = descriptor_read(slab[1], ks)
                part = part + a_small @ b_big
                part = part + a_big @ b_small
                part = part + a_big @ b_big
            run = run + part
        out[:, pas * panel:(pas + 1) * panel] = run
    return out


def test_slab_layout_constants_describe_one_k_step():
    """A k step is two core matrices along k (kStepBytes = 2 kLbo), a
    slab's 8 n-groups are kSbo apart, and a slab part of 64 x 64 floats
    holds 16 k-groups of 8 core matrices each: every float of a part is
    read exactly once over the 8 k steps."""
    c = slab_constants()
    assert (c["kPanel"], c["kLbo"], c["kSbo"], c["kStepBytes"]) == \
        (64, 128, 2048, 256)
    part = torch.arange(64 * 64, dtype=torch.float32)
    seen = torch.cat([descriptor_read(part, ks).flatten() for ks in range(8)])
    assert torch.equal(seen.sort().values, part)


@pytest.mark.parametrize("h", [64, 97, 128, 200, 256])
def test_slabs_read_through_the_descriptors_give_the_weight(h):
    """The split pass's slabs, read back through the descriptors' layout,
    hold every element of W (zero-padded to the padded width) as big +
    small, and the zero padding exactly."""
    hp = max(64, -(-h // 64) * 64)
    w = torch.tensor(np.random.RandomState(h).randn(h, h) / np.sqrt(h),
                     dtype=torch.float32)
    slabs = fwd_slabs(w, hp)
    np_ = hp // 64
    back = torch.zeros(hp, hp)
    for pas in range(np_):
        for chunk in range(np_):
            for ks in range(8):
                rows = slice(chunk * 64 + 8 * ks, chunk * 64 + 8 * ks + 8)
                slab = slabs[pas * np_ + chunk]
                back[rows, pas * 64:(pas + 1) * 64] = (
                    descriptor_read(slab[0], ks).double()
                    + descriptor_read(slab[1], ks).double()).float()
    assert float((back[:h, :h] - w).abs().max()) <= 2.0 ** -21 * float(
        w.abs().max())
    assert not back[h:].any() and not back[:, h:].any()


@pytest.mark.parametrize("h", [97, 128, 256])
@pytest.mark.parametrize("name", ("a1 @ W2", "msg @ Wc1"))
def test_slab_products_meet_the_fp32_budget(name, h):
    """The forward's two products as #1's tile route takes them from the
    slabs (native width h, run at the padded width): within the split-TF32
    budget of the float64 product at every column, the padded columns
    exactly zero."""
    hp = max(64, -(-h // 64) * 64)
    a, w = chain_products(1.0, h, g=4)[name]
    got = slab_product(a, fwd_slabs(w, hp), hp)
    ref = a.double() @ w.double()
    bound = TOL * max(1.0, float(ref.abs().max()))
    assert float((got[:, :h].double() - ref).abs().max()) <= bound
    assert not got[:, h:].any()
