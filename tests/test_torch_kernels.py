"""nonode_tpu_torch.ops.kernels.egnn_fused against the JAX package.

The plain PyTorch version of the fused pairwise-message chain is held to the
JAX Pallas kernel (interpret mode on the CPU, as nonode_tpu runs it there)
and, through EGNNLayer, to the JAX dense path. The CUDA kernel itself runs
only on the card: its tests are in test_torch_cuda.py.

Tolerance 1e-5 (rtol and atol): both sides are fp32 and differ only in the
order of sums over H <= 32 products and N <= 6 edges.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.ops.dense_graph import EGNNLayer as JaxEGNNLayer
from nonode_tpu.ops.pallas.egnn_fused import pairwise_message as jax_pairwise
from nonode_tpu_torch.nn import silu
from nonode_tpu_torch.ops.dense_graph import EGNNLayer
from nonode_tpu_torch.ops.kernels import KERNELS, build, egnn_fused
from torch_port_util import assert_close, egnn_layer_sd, t

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = Path(__file__).resolve().parents[1]


def _chain_inputs(g, n, h, e, seed, coord_scale=1.0):
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(rng.randn(g, n, 3))
    hi = f32(0.5 * rng.randn(g, n, h))
    hj = f32(0.5 * rng.randn(g, n, h))
    efea = f32(rng.randn(g, n, n, e))
    b = 1.0 / np.sqrt(h)
    weights = (f32(0.3 * rng.randn(1, h)), f32(0.3 * rng.randn(e, h)),
               f32(0.1 * rng.randn(1, h)), f32(b * rng.randn(h, h)),
               f32(0.1 * rng.randn(1, h)), f32(b * rng.randn(h, h)),
               f32(0.1 * rng.randn(1, h)),
               f32(coord_scale * b * rng.randn(h, 1)),
               f32(0.1 * rng.randn(1, 1)))
    return x, hi, hj, efea, weights


def _mask(n, isolated=None, seed=3):
    mask = 1.0 - np.eye(n, dtype=np.float32)
    if isolated is not None:
        rng = np.random.RandomState(seed)
        adj = (rng.rand(n, n) < 0.6).astype(np.float32)
        adj = np.maximum(adj, adj.T)
        adj[isolated, :] = 0.0
        adj[:, isolated] = 0.0
        mask = mask * adj
    return mask


@pytest.mark.parametrize("h", [16, 96])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("clip_edges", [False, True])
def test_plain_version_matches_pallas_interpret(clip_edges, masked, h):
    g, n, e = 6, 5, 2
    # a large coordinate head makes per-edge forces exceed the +-100 clip
    x, hi, hj, efea, weights = _chain_inputs(
        g, n, h, e, seed=0, coord_scale=400.0 if clip_edges else 1.0)
    mask = _mask(n, isolated=4 if masked else None)
    jf, jm = jax_pairwise(clip_edges, *map(jnp.asarray, (x, hi, hj, efea, mask)),
                          tuple(map(jnp.asarray, weights)))
    args = (*map(t, (x, hi, hj, efea, mask)), tuple(map(t, weights)))
    tf, tm = egnn_fused.pairwise_message_reference(clip_edges, *args)
    for a, b in ((tf, jf), (tm, jm)):
        # at H=96 the sums run over 96 products and, with the clip, the
        # coordinate head is scaled 400x: the rounding scales with the
        # largest entry, so the atol does too
        scale = 1.0 if h == 16 else max(1.0, float(np.abs(b).max()))
        assert_close(a, b, rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    if clip_edges:
        unclipped, _ = egnn_fused.pairwise_message_reference(False, *args)
        assert (unclipped - tf).abs().max() > 1.0, "the clip never engaged"
    if masked:
        assert float(tf[:, 4].abs().max()) == 0.0   # isolated: degree clamp


@pytest.mark.parametrize("h", [16, 96])
@pytest.mark.parametrize("edge_mask", [False, True])
@pytest.mark.parametrize("with_v", [False, True])
def test_fused_layer_matches_jax_dense_layer(with_v, edge_mask, h):
    """The port's EGNNLayer on the fused route (the plain version on the
    CPU) against the JAX dense EGNNLayer(fused=False); H=96 is a width the
    card runs zero-padded to 128."""
    n, e = 5, 2
    jl = JaxEGNNLayer(h, e, with_v=with_v)
    params = jl.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, n, 3).astype(np.float32)
    hh = rng.randn(3, 4, n, h).astype(np.float32)
    v = rng.randn(3, 4, n, 3).astype(np.float32)
    efea = rng.randn(3, 4, n, n, e).astype(np.float32)
    em = _mask(n, isolated=2) if edge_mask else None

    jx, jv, jh = jl(params, jnp.asarray(x), jnp.asarray(hh), jnp.asarray(efea),
                    v=jnp.asarray(v) if with_v else None,
                    edge_mask=None if em is None else jnp.asarray(em))
    layer = EGNNLayer(h, e, with_v=with_v, fused=True, device="cpu")
    layer.load_state_dict(egnn_layer_sd(params), strict=True)
    assert layer._use_fused(t(x), None if em is None else t(em))
    with torch.no_grad():
        tx, tv, th = layer(t(x), t(hh), t(efea), v=t(v) if with_v else None,
                           edge_mask=None if em is None else t(em))
    assert_close(tx, jx, **TOL)
    assert_close(th, jh, **TOL)
    if with_v:
        assert_close(tv, jv, rtol=0, atol=0)


def _padded_cut(clip, args, hp, i0=0, cot=None):
    """The plain version at the padded width ``hp`` (``pad_width``), cut
    back to the inputs' width (``cut_width``): what a padded launch
    returns. With ``cot`` the backward's outputs, else the forward's."""
    x, hi, hj, efea, mask, weights = args
    h, e = hi.shape[-1], efea.shape[-1]
    wp, hip, hjp = egnn_fused.pad_width(weights, hi, hj, hp)
    stacked = egnn_fused.seeds_of(weights) is not None
    if cot is None:
        fwd = egnn_fused.pairwise_message_seeds_reference if stacked else \
            egnn_fused.pairwise_message_reference
        totf, totm = fwd(clip, x, hip, hjp, efea, mask, wp,
                         *(() if stacked else (i0,)))
        (totm,), _ = egnn_fused.cut_width(h, e, (totm,))
        return totf, totm
    gtotf, gtotm = cot
    gtotm = torch.nn.functional.pad(gtotm, (0, hp - h))
    bwd = egnn_fused.pairwise_message_bwd_seeds_reference if stacked else \
        egnn_fused.pairwise_message_bwd_reference
    dx, dhi, dhj, defea, dw = bwd(clip, x, hip, hjp, efea, mask, wp, gtotf,
                                  gtotm, *(() if stacked else (i0,)))
    (dhi, dhj), dw = egnn_fused.cut_width(h, e, (dhi, dhj), dw)
    return (dx, dhi, dhj, defea, *dw)


@pytest.mark.parametrize("form", ["whole", "clip", "seed axis",
                                  "receiver slice"])
@pytest.mark.parametrize("h", [32, 96, 100])
def test_padded_width_gives_the_native_width(h, form):
    """A width the kernels are not built for, zero-padded to the next one
    (64 or 128) and cut back, gives the chain and its gradients at the
    native width: the plain versions at both, within 1e-6 x max(1,
    max|native|) (fp32 sums with zeros added, in another order). The
    forms: the whole graph, the per-edge clip engaged, two stacked weight
    sets, receivers 2-4 of 5. With the clip, tot_f is a mean of per-edge
    forces of up to the clip's 100 each, so its scale includes 100."""
    hp = egnn_fused.padded_width(h)
    assert hp == (64 if h <= 64 else 128)
    clip = form == "clip"
    x, hi, hj, efea, weights = _chain_inputs(
        4, 5, h, 2, seed=h, coord_scale=400.0 if clip else 1.0)
    mask, i0 = _mask(5), 0
    if form == "seed axis":
        other = _chain_inputs(4, 5, h, 2, seed=h + 1)[4]
        weights = tuple(np.stack(w) for w in zip(weights, other))
    if form == "receiver slice":
        i0 = 2
        hi, efea, mask = hi[:, 2:], efea[:, 2:], mask[2:]
    args = (*map(t, (x, hi, hj, efea, mask)), tuple(map(t, weights)))
    rng = np.random.RandomState(h)
    cot = (t(rng.randn(*hi.shape[:2], 3)), t(rng.randn(*hi.shape)))
    native = egnn_fused.pairwise_message_fwd(clip, *args, i0=i0)
    bnative = egnn_fused.pairwise_message_bwd(clip, *args, *cot, i0=i0)
    bnative = (*bnative[:4], *bnative[4])
    for got, want in ((_padded_cut(clip, args, hp, i0), native),
                      (_padded_cut(clip, args, hp, i0, cot), bnative)):
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and a.is_contiguous()
            err = float((a - b).abs().max())
            scale = max(1.0, float(b.abs().max()),
                        egnn_fused.CLIP if clip and i == 0 else 0.0)
            assert err <= 1e-6 * scale, (i, err, scale)
    if clip:
        free = egnn_fused.pairwise_message_reference(False, *args)[0]
        assert float((free - native[0]).abs().max()) > 1.0


def test_widths_above_128_raise_naming_the_limit():
    for h in (129, 160, 256):
        with pytest.raises(ValueError, match="1<=H<=128"):
            egnn_fused.padded_width(h)
    assert [egnn_fused.padded_width(h) for h in (1, 64, 65, 128)] == \
        [64, 64, 128, 128]


def test_gate_matches_the_tpu_gate():
    """Each config answers the same in both gates; neither limits the width."""
    from nonode_tpu.ops.pallas.egnn_fused import supported as jax_supported
    ok = dict(n=5, hidden=64, flat=False, norm=False, tanh=False)
    for change, accepted in (
            ({}, True), (dict(flat=True), False), (dict(norm=True), False),
            (dict(tanh=True), False), (dict(bf16=True), False),
            (dict(n=64), True), (dict(n=65), False), (dict(hidden=48), True),
            (dict(hidden=16), True), (dict(tanh_act=True), False)):
        bf16 = change.pop("bf16", False)
        tanh_act = change.pop("tanh_act", False)
        kw = {**ok, **change}
        want = jax_supported(dtype=jnp.bfloat16 if bf16 else jnp.float32,
                             act=jnp.tanh if tanh_act else jax.nn.silu, **kw)
        got = egnn_fused.supported(
            dtype=torch.bfloat16 if bf16 else torch.float32,
            act=torch.tanh if tanh_act else silu, **kw)
        assert got == want == accepted, (change, got, want)


def test_layer_gate_refuses_flat_and_batched_edge_masks():
    layer = EGNNLayer(16, 2, flat=True, device="cpu")
    assert not layer._use_fused(torch.zeros(2, 5, 3), None)
    layer = EGNNLayer(16, 2, device="cpu")
    assert layer._use_fused(torch.zeros(2, 5, 3), torch.ones(5, 5))
    assert not layer._use_fused(torch.zeros(2, 5, 3), torch.ones(2, 5, 5))


def test_wrapper_takes_plain_version_only_on_cpu():
    x, hi, hj, efea, weights = _chain_inputs(2, 5, 16, 2, seed=4)
    args = (*map(t, (x, hi, hj, efea, _mask(5))), tuple(map(t, weights)))
    before = egnn_fused.pairwise_message.launches
    out = egnn_fused.pairwise_message(False, *args)
    ref = egnn_fused.pairwise_message_reference(False, *args)
    assert egnn_fused.pairwise_message.launches == before   # no kernel ran
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    meta = [a.to("meta") for a in args[:5]]
    with pytest.raises(ValueError, match="unsupported device"):
        egnn_fused.pairwise_message(False, *meta, args[5])


def test_registry_points_at_sources_and_tpu_kernels():
    tpu_kernel = {"egnn_pairwise_fwd": "def _fwd_kernel",
                  "egnn_pairwise_bwd": "def _bwd_kernel",
                  "nbody_charged_force": "def _charged_kernel",
                  "nbody_gravity_accel": "def _gravity_kernel",
                  "nbody_charged_leapfrog": "def _charged_block_kernel",
                  "nbody_gravity_leapfrog": "def _gravity_block_kernel"}
    assert [k["name"] for k in KERNELS] == list(tpu_kernel)
    # every function of nonode_tpu that reaches pl.pallas_call has a kernel
    assert len({k["replaces"] for k in KERNELS}) == 6
    for k in KERNELS:
        assert (REPO / k["source"]).is_file()
        assert k["source"].endswith(k["csrc"])
        path, line = k["replaces"].rsplit(":", 1)
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(tpu_kernel[k["name"]]), text
        assert isinstance(k["wrapper"].launches, int)
    sources = sorted({k["csrc"] for k in KERNELS})
    assert len(sources) == 4
    for source in sources:
        lib = build.library_path(source)
        assert lib.parent == build.BUILD_DIR and lib.suffix == ".so"
        assert lib == build.library_path(source)          # content-hashed
    assert len({build.library_path(s) for s in sources}) == len(sources)
