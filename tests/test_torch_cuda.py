"""Tests of the port's CUDA kernels (the pairwise chain's forward and
backward, the N-body forces and leapfrog blocks), of SEGNO's weight-tied
steps on them, of the spectral conv's cuFFT path and of PhaseTimer's wait
on the card, on the card only.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel
has no CPU mode). The file imports neither JAX nor nonode_tpu, so that it
runs on the card's machine, which has neither:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: max|kernel - plain| <= 1e-4 x max(1, max|plain|); both are fp32
(the EGNO kernels' products in split TF32, fp32-class), with sums of up to
128 products (the N-body kernels: up to N pair terms, and up to 100
micro-steps) taken in another order. #1/#2 are held at both widths they
are built for, H=64 and H=128 (mocap's, on the skeleton mask of
chip_smoke.py's written CMU skeleton), and at widths that run on them
zero-padded (H=32, 96, 100); H=64 also to the bits of the build that had
H=64 alone.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nonode_tpu_torch.models.segno import SEGNO
from nonode_tpu_torch.ops.dense_graph import EGNNLayer
from nonode_tpu_torch.ops.kernels import egnn_fused, nbody_sim, pairwise
from nonode_tpu_torch.ops.spectral import SpectralConv
from nonode_tpu_torch.sim.simulators import ChargedSim, GravitySim
from nonode_tpu_torch.train.loop import SEGNOExperiment

RTOL = 1e-4
# sha256 of the H=64 outputs of #1 and #2 (scripts/time_pairwise_kernels.py:
# h64_digest) from the build that instantiated H=64 alone, on an H100 SXM
H64_DIGEST = "33fb1907313fbc658085584579d82703bc32911819bb4164c0b6efeb622d09c4"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(g, n, h, e, seed, dev, coord_scale=1.0, isolated=None):
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.tensor(scale * rng.randn(*shape), dtype=torch.float32,
                            device=dev)

    mask = 1.0 - torch.eye(n, device=dev)
    if isolated == "skeleton":            # mocap's skeleton + 2-hop mask
        import chip_smoke
        mask = chip_smoke.mocap_mask(dev)
    elif isolated is not None:
        adj = torch.tensor(rng.rand(n, n) < 0.4, dtype=torch.float32,
                           device=dev)
        adj = torch.maximum(adj, adj.T)
        adj[isolated] = 0.0
        adj[:, isolated] = 0.0
        mask = mask * adj
    b = 1.0 / np.sqrt(h)
    weights = (f(1, h, scale=0.3), f(e, h, scale=0.3), f(1, h, scale=0.1),
               f(h, h, scale=b), f(1, h, scale=0.1), f(h, h, scale=b),
               f(1, h, scale=0.1), f(h, 1, scale=coord_scale * b),
               f(1, 1, scale=0.1))
    return (f(g, n, 3), f(g, n, h, scale=0.5), f(g, n, h, scale=0.5),
            f(g, n, n, e), mask, weights)


def _assert_close(got, want):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        err = float((a - b).abs().max())
        assert err <= RTOL * max(1.0, float(b.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,h,e,clip,isolated", [
    (2560, 5, 64, 2, False, None),     # the serving path's shape
    (2560, 5, 64, 2, True, None),      # SEGNO's per-edge clip
    (256, 5, 64, 2, True, None),       # SEGNO's path: G = its batch
    (3, 5, 64, 2, True, None),         # 75 edge rows: one ragged tile
    (256, 31, 64, 2, False, 3),        # mocap: 2-D edge mask, a lone node
    (7, 5, 64, 2, False, None),        # a ragged tail: G*N not a block multiple
    (9, 64, 64, 3, True, 10),          # N at the gate's limit, E=3
])
def test_kernel_matches_plain_version(dev, g, n, h, e, clip, isolated):
    args = _inputs(g, n, h, e, seed=n + h, dev=dev,
                   coord_scale=400.0 if clip else 1.0, isolated=isolated)
    before = egnn_fused.pairwise_message.launches
    with torch.no_grad():
        got = egnn_fused.pairwise_message(clip, *args)
        torch.cuda.synchronize()
        want = egnn_fused.pairwise_message_reference(clip, *args)
    assert egnn_fused.pairwise_message.launches == before + 1
    _assert_close(got, want)
    if clip:
        unclipped = egnn_fused.pairwise_message_reference(False, *args)[0]
        assert float((unclipped - want[0]).abs().max()) > 1.0


@pytest.mark.cuda
def test_kernel_is_deterministic(dev):
    args = _inputs(512, 5, 64, 2, seed=1, dev=dev)
    with torch.no_grad():
        a = egnn_fused.pairwise_message(False, *args)
        b = egnn_fused.pairwise_message(False, *args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, hi, hj, efea, mask, weights = _inputs(4, 5, 64, 2, seed=2, dev=dev)
    with pytest.raises(ValueError, match="contiguous"):
        egnn_fused.pairwise_message(False, x.transpose(0, 1).contiguous()
                                    .transpose(0, 1), hi, hj, efea, mask,
                                    weights)
    with pytest.raises(TypeError, match="float32"):
        egnn_fused.pairwise_message(False, x.double(), hi, hj, efea, mask,
                                    weights)
    with pytest.raises(ValueError, match="wg has shape"):
        egnn_fused.pairwise_message(False, x, hi[..., :48].contiguous(),
                                    hj[..., :48].contiguous(), efea, mask,
                                    weights)
    gtotf, gtotm = torch.ones_like(x), torch.ones_like(hi)
    with pytest.raises(ValueError, match="wg has shape"):
        egnn_fused.pairwise_message_bwd(False, x, hi[..., :48].contiguous(),
                                        hj[..., :48].contiguous(), efea, mask,
                                        weights, gtotf, gtotm[..., :48])
    with pytest.raises(ValueError, match="gtotm has shape"):
        egnn_fused.pairwise_message_bwd(False, x, hi, hj, efea, mask,
                                        weights, gtotf, gtotm[:2])


def _bwd_inputs(g, n, e, clip, isolated, dev, h=64):
    args = _inputs(g, n, h, e, seed=n + 7, dev=dev,
                   coord_scale=400.0 if clip else 1.0, isolated=isolated)
    rng = np.random.RandomState(n)
    cot = tuple(torch.tensor(rng.randn(*s), dtype=torch.float32, device=dev)
                for s in ((g, n, 3), (g, n, h)))
    return args, cot


def _flat(out):
    dx, dhi, dhj, defea, dw = out
    return (dx, dhi, dhj, defea, *dw)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,e,clip,isolated", [
    (2560, 5, 2, False, None),         # the training path's shape
    (2560, 5, 2, True, None),          # SEGNO's per-edge clip, engaged
    (256, 5, 2, True, None),           # SEGNO's training path: G = batch
    (3, 5, 2, True, None),             # 75 edge rows: one ragged tile
    (256, 31, 2, False, 3),            # mocap: 2-D edge mask, a lone node
    (7, 5, 2, False, None),            # a ragged last block
    (9, 64, 3, True, 10),              # N at the gate's limit, E=3
])
def test_backward_kernel_matches_plain_version(dev, g, n, e, clip, isolated):
    args, cot = _bwd_inputs(g, n, e, clip, isolated, dev)
    before = egnn_fused.pairwise_message_bwd.launches
    got = _flat(egnn_fused.pairwise_message_bwd(clip, *args, *cot))
    torch.cuda.synchronize()
    want = _flat(egnn_fused.pairwise_message_bwd_reference(clip, *args, *cot))
    assert egnn_fused.pairwise_message_bwd.launches == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape
    _assert_close(got, want)


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(dev):
    args, cot = _bwd_inputs(512, 5, 2, False, None, dev)
    a = _flat(egnn_fused.pairwise_message_bwd(False, *args, *cot))
    b = _flat(egnn_fused.pairwise_message_bwd(False, *args, *cot))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _scaled_inputs(g, n, e, scale, dev):
    """_bwd_inputs with hi and hj multiplied by ``scale``."""
    (x, hi, hj, efea, mask, weights), cot = _bwd_inputs(g, n, e, False, None,
                                                        dev)
    return (x, hi * scale, hj * scale, efea, mask, weights), cot


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["G=1", "G=2561", "N=64 E=3 many graphs",
                                  "activations x200"])
def test_split_tf32_kernels_on_the_persistent_grid(dev, case):
    """Both EGNO kernels on the shapes that exercise the persistent grid and
    the split TF32 products: fewer graphs than blocks; units that do not
    divide evenly over the grid; N=64 graphs of 32 tiles each, several to a
    block; activations of order 10^2, where the TF32 rounding of the
    operands weighs most. Each within RTOL of its plain version, two runs
    bitwise equal."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g, n, e, scale = {"G=1": (1, 5, 2, 1.0), "G=2561": (2561, 5, 2, 1.0),
                      "N=64 E=3 many graphs": (2 * sms + 7, 64, 3, 1.0),
                      "activations x200": (2560, 5, 2, 200.0)}[case]
    args, cot = _scaled_inputs(g, n, e, scale, dev)
    with torch.no_grad():
        got = egnn_fused.pairwise_message(False, *args)
        again = egnn_fused.pairwise_message(False, *args)
        torch.cuda.synchronize()
        want = egnn_fused.pairwise_message_reference(False, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_close(got, want)
    got = _flat(egnn_fused.pairwise_message_bwd(False, *args, *cot))
    again = _flat(egnn_fused.pairwise_message_bwd(False, *args, *cot))
    torch.cuda.synchronize()
    want = _flat(egnn_fused.pairwise_message_bwd_reference(False, *args,
                                                           *cot))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,e,clip,isolated,scale", [
    (60, 31, 1, False, "skeleton", 1.0),   # mocap: G = T x B, E=1
    (60, 31, 1, True, "skeleton", 1.0),    # the same with the clip
    (7, 5, 2, False, None, 1.0),           # ragged tiles, 5 graphs a unit
    (9, 64, 3, True, 10, 1.0),             # N at the gate's limit, E=3
    (60, 31, 1, False, "skeleton", 200.0),   # activations of order 10^2
])
def test_h128_kernels_match_plain_versions(dev, g, n, e, clip, isolated,
                                           scale):
    """#1 and #2 at H=128 (weights read from global memory and split as
    they load; #2 on 64-row tiles of 4 warps): within RTOL of the plain
    versions, two runs bitwise equal, one launch each."""
    (x, hi, hj, efea, mask, weights), cot = _bwd_inputs(
        g, n, e, clip, isolated, dev, h=128)
    args = (x, hi * scale, hj * scale, efea, mask, weights)
    before = (egnn_fused.pairwise_message.launches,
              egnn_fused.pairwise_message_bwd.launches)
    with torch.no_grad():
        got = egnn_fused.pairwise_message(clip, *args)
        again = egnn_fused.pairwise_message(clip, *args)
    bgot = _flat(egnn_fused.pairwise_message_bwd(clip, *args, *cot))
    bagain = _flat(egnn_fused.pairwise_message_bwd(clip, *args, *cot))
    torch.cuda.synchronize()
    assert (egnn_fused.pairwise_message.launches,
            egnn_fused.pairwise_message_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(bgot, bagain))
    with torch.no_grad():
        _assert_close(got, egnn_fused.pairwise_message_reference(clip, *args))
    want = _flat(egnn_fused.pairwise_message_bwd_reference(clip, *args, *cot))
    assert [a.shape for a in bgot] == [b.shape for b in want]
    _assert_close(bgot, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 96, 100])
@pytest.mark.parametrize("form", ["EGNO G=2560", "clip", "seed axis K=2"])
def test_widths_not_instantiated_run_padded_on_the_card(dev, h, form):
    """H=32, 96 and 100 (not a multiple of 4) run on the H=64 and H=128
    kernels, zero-padded in the wrappers: #1 and #2 within RTOL of their
    plain versions at the native width, two runs bitwise equal, one launch
    each; at EGNO's serving shape, with the clip engaged, and with two
    stacked weight sets. The raw entry points still refuse such a width
    (cudaErrorInvalidValue, and no scratch size): the one dispatch on the
    width that both kernels and the scratch share."""
    clip = form == "clip"
    (x, hi, hj, efea, mask, weights), cot = _bwd_inputs(
        2560, 5, 2, clip, None, dev, h=h)
    if form == "seed axis K=2":
        other = _inputs(1, 5, h, 2, seed=h, dev=dev)[5]
        weights = tuple(torch.stack(w) for w in zip(weights, other))
    args = (x, hi, hj, efea, mask, weights)
    stacked = form == "seed axis K=2"
    plain = egnn_fused.pairwise_message_seeds_reference if stacked else \
        egnn_fused.pairwise_message_reference
    bplain = egnn_fused.pairwise_message_bwd_seeds_reference if stacked \
        else egnn_fused.pairwise_message_bwd_reference
    before = (egnn_fused.pairwise_message.launches,
              egnn_fused.pairwise_message_bwd.launches)
    with torch.no_grad():
        got = egnn_fused.pairwise_message(clip, *args)
        again = egnn_fused.pairwise_message(clip, *args)
    bgot = _flat(egnn_fused.pairwise_message_bwd(clip, *args, *cot))
    bagain = _flat(egnn_fused.pairwise_message_bwd(clip, *args, *cot))
    torch.cuda.synchronize()
    assert (egnn_fused.pairwise_message.launches,
            egnn_fused.pairwise_message_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(bgot, bagain))
    with torch.no_grad():
        want = plain(clip, *args)
        if clip:
            free = plain(False, *args)[0]
            assert float((free - want[0]).abs().max()) > 1.0
    _assert_close(got, want)
    bwant = _flat(bplain(clip, *args, *cot))
    assert [a.shape for a in bgot] == [b.shape for b in bwant]
    _assert_close(bgot, bwant)
    invalid = 1                                  # cudaErrorInvalidValue
    # g, n, h, e, k, clip, the receiver slice (ni, i0), stream
    shape = [4, 5, h, 2, 1, 0, 5, 0, None]
    assert egnn_fused._bind_fwd()(*([None] * 16 + shape)) == invalid
    bwd, scratch = egnn_fused._bind_bwd()
    assert bwd(*([None] * 22 + shape)) == invalid
    assert scratch(4, 5, h, 2, 1, 5) == -1
    assert scratch(4, 5, 128, 2, 1, 5) > 0 and scratch(4, 5, 64, 2, 1, 5) > 0


@pytest.mark.cuda
def test_widths_above_128_and_bad_slices_raise_on_the_card(dev):
    """A width above 128 raises before a launch, naming the limit; the
    entry points refuse a slice out of range and a slice with stacked
    weights."""
    (x, hi, hj, efea, mask, weights), cot = _bwd_inputs(4, 5, 2, False, None,
                                                        dev, h=160)
    before = (egnn_fused.pairwise_message.launches,
              egnn_fused.pairwise_message_bwd.launches)
    with torch.no_grad(), pytest.raises(ValueError, match="H<=128"):
        egnn_fused.pairwise_message(False, x, hi, hj, efea, mask, weights)
    with pytest.raises(ValueError, match="H<=128"):
        egnn_fused.pairwise_message_bwd(False, x, hi, hj, efea, mask,
                                        weights, *cot)
    assert (egnn_fused.pairwise_message.launches,
            egnn_fused.pairwise_message_bwd.launches) == before
    invalid = 1                                  # cudaErrorInvalidValue
    bwd, _ = egnn_fused._bind_bwd()
    for ni, i0, k in ((3, 3, 1), (0, 0, 1), (2, 0, 2)):
        bad = [4, 5, 64, 2, k, 0, ni, i0, None]
        assert egnn_fused._bind_fwd()(*([None] * 16 + bad)) == invalid
        assert bwd(*([None] * 22 + bad)) == invalid


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,space,clip,h", [
    (50, 10, 2, False, 64),      # the --dp 2 --space 2 path: a rank's batch
    (50, 10, 2, True, 64),       # SEGNO's clip
    (7, 31, 3, False, 128),      # H=128, slices of 10, 10 and 11 receivers
    (3, 64, 4, True, 64),        # N at the gate's limit
])
def test_receiver_slices_give_the_whole_launch(dev, g, n, space, clip, h):
    """#1/#2 on receiver slices [i0, i0 + ni): each within RTOL of its
    plain version; the slices' tot_f, tot_m and defea side by side bitwise
    the whole launch's (#1's tile is whole receiver rows; defea is per
    edge); their dhi side by side and their dx, dhj and weight gradients
    summed within 1e-5 of it (#2's tiles cut a graph of N > 11 (H=64) or
    N > 8 (H=128) elsewhere in a slice, and a row's sum over j adds the
    tiles' parts; the sums over i are taken in parts)."""
    (x, hi, hj, efea, mask, w), cot = _bwd_inputs(g, n, 2, clip, None, dev,
                                                  h=h)
    bounds = np.linspace(0, n, space + 1).astype(int)
    with torch.no_grad():
        whole = egnn_fused.pairwise_message(clip, x, hi, hj, efea, mask, w)
    bwhole = _flat(egnn_fused.pairwise_message_bwd(clip, x, hi, hj, efea,
                                                   mask, w, *cot))
    fwd, bwd = [], []
    for i0, i1 in zip(bounds[:-1], bounds[1:]):
        i0 = int(i0)
        args = (x, hi[:, i0:i1].contiguous(), hj,
                efea[:, i0:i1].contiguous(), mask[i0:i1].contiguous(), w)
        c = tuple(t[:, i0:i1].contiguous() for t in cot)
        with torch.no_grad():
            fwd.append(egnn_fused.pairwise_message(clip, *args, i0=i0))
        bwd.append(_flat(egnn_fused.pairwise_message_bwd(clip, *args, *c,
                                                         i0=i0)))
        _assert_close(fwd[-1], egnn_fused.pairwise_message_reference(
            clip, *args, i0=i0))
        _assert_close(bwd[-1], _flat(egnn_fused.pairwise_message_bwd_reference(
            clip, *args, *c, i0=i0)))
    for k in range(2):
        assert torch.equal(torch.cat([f[k] for f in fwd], 1), whole[k])
    assert torch.equal(torch.cat([b[3] for b in bwd], 1), bwhole[3])
    for k in range(len(bwhole)):                 # dx, dhi, dhj, weights
        if k == 3:
            continue
        got = torch.cat([b[k] for b in bwd], 1) if k == 1 else \
            sum(b[k] for b in bwd)
        err = float((got - bwhole[k]).abs().max())
        assert err <= 1e-5 * max(1.0, float(bwhole[k].abs().max())), (k, err)


@pytest.mark.cuda
def test_h64_kernels_keep_the_bits_of_the_h64_only_build(dev):
    """The H=64 outputs of #1 and #2 (scripts/time_pairwise_kernels.py's
    digest: the slice and SEGNO shapes, N=31 with E=1, two stacked weight
    sets) are the bits of the build that instantiated H=64 alone, recorded
    on an H100 SXM (132 SMs: the persistent grid, and with it #2's sum of
    its per-block weight gradients, depends on the SM count)."""
    import importlib.util

    import chip_smoke
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms != 132:
        pytest.skip(f"the digest was recorded on 132 SMs; this card has "
                    f"{sms}")
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "time_pairwise_kernels.py"
    spec = importlib.util.spec_from_file_location("time_pairwise", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.h64_digest(chip_smoke, egnn_fused, dev) == H64_DIGEST


@pytest.mark.cuda
def test_egnn_layer_kernel_route_gradients_match_dense_route(dev):
    """The autograd.Function on the card (forward and backward kernels)
    against plain autograd through the dense route of the same layer."""
    gen = torch.Generator().manual_seed(1)
    layer = EGNNLayer(64, 2, with_v=True, fused=True, device=dev,
                      generator=gen)
    rng = np.random.RandomState(4)
    t = lambda *s: torch.tensor(rng.randn(*s), dtype=torch.float32,  # noqa: E731
                                device=dev, requires_grad=True)
    ins = (t(10, 8, 5, 3), t(10, 8, 5, 64), t(8, 5, 5, 2), t(10, 8, 5, 3))
    grads = []
    for fused in (True, False):
        layer.fused = fused
        layer.zero_grad(set_to_none=True)
        for a in ins:
            a.grad = None
        before = egnn_fused.pairwise_message_bwd.launches
        xo, _, ho = layer(*ins[:3], v=ins[3])
        (xo.square().sum() + ho.sin().sum()).backward()
        assert egnn_fused.pairwise_message_bwd.launches == before + fused
        grads.append([a.grad.clone() for a in ins]
                     + [p.grad.clone() for p in layer.parameters()])
    _assert_close(*grads)


@pytest.mark.cuda
def test_egnn_layer_kernel_route_matches_dense_route(dev):
    gen = torch.Generator().manual_seed(0)
    layer = EGNNLayer(64, 2, with_v=True, fused=True, device=dev,
                      generator=gen)
    rng = np.random.RandomState(3)
    t = lambda *s: torch.tensor(rng.randn(*s), dtype=torch.float32, device=dev)
    x, h, v, efea = t(10, 8, 5, 3), t(10, 8, 5, 64), t(10, 8, 5, 3), \
        t(8, 5, 5, 2)
    before = egnn_fused.pairwise_message.launches
    with torch.no_grad():
        fused = layer(x, h, efea, v=v)
        layer.fused = False
        dense = layer(x, h, efea, v=v)
    assert egnn_fused.pairwise_message.launches == before + 1
    for a, b in zip(fused, dense):
        err = float((a - b).abs().max())
        assert err <= RTOL * max(1.0, float(b.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 96, 100])
def test_egnn_layer_of_another_width_runs_on_the_card(dev, h):
    """The gate has no width limit, as the TPU's: a layer at a width the
    kernels are not built for takes them, zero-padded, and its output and
    every gradient match the dense route of the same layer."""
    layer = EGNNLayer(h, 2, with_v=True, fused=True, device=dev,
                      generator=torch.Generator().manual_seed(h))
    rng = np.random.RandomState(h)
    t = lambda *s: torch.tensor(rng.randn(*s), dtype=torch.float32,  # noqa: E731
                                device=dev, requires_grad=True)
    ins = (t(10, 8, 5, 3), t(10, 8, 5, h), t(8, 5, 5, 2), t(10, 8, 5, 3))
    assert layer._use_fused(ins[0], None)
    outs, grads = [], []
    for fused in (True, False):
        layer.fused = fused
        layer.zero_grad(set_to_none=True)
        for a in ins:
            a.grad = None
        before = (egnn_fused.pairwise_message.launches,
                  egnn_fused.pairwise_message_bwd.launches)
        xo, vo, ho = layer(*ins[:3], v=ins[3])
        (xo.square().sum() + ho.sin().sum()).backward()
        assert (egnn_fused.pairwise_message.launches,
                egnn_fused.pairwise_message_bwd.launches) == \
            (before[0] + fused, before[1] + fused)
        outs.append([o.detach() for o in (xo, vo, ho)])
        grads.append([a.grad.clone() for a in ins]
                     + [p.grad.clone() for p in layer.parameters()])
    _assert_close(*outs)
    _assert_close(*grads)


def _segno_pair(dev, b=32, seed=0):
    """The model_confs.yaml:SEGNO model from one seed on the card and on the
    CPU, and a charged batch (loc, vel, charges, w, loc_end, in_steps) of
    one input on each."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)       # noqa: E731
    q = rng.choice([-1.0, 1.0], (b, 5, 1)).astype(np.float32)
    batch = (f(b, 5, 3), 0.3 * f(b, 5, 3), q,
             np.einsum("bik,bjk->bij", q, q)[..., None], f(b, 5, 3))
    pairs = []
    for where in (dev, torch.device("cpu")):
        model = SEGNO(device=where,
                      generator=torch.Generator().manual_seed(seed))
        pairs.append((SEGNOExperiment(model),
                      tuple(torch.from_numpy(a).to(where) for a in batch)
                      + (None,)))
    return pairs


@pytest.mark.cuda
def test_segno_step_gradients_match_the_cpu(dev):
    """A SEGNO training step's loss and the gradient of every parameter,
    each summed over the 10 weight-tied steps through #2, card against the
    CPU: within 1e-3 x max(1, max|g|), the chip_smoke gate (fp32 in another
    order through 10 steps)."""
    grads = []
    for exp, batch in _segno_pair(dev):
        before = egnn_fused.pairwise_message_bwd.launches
        loss, _ = exp._loss(batch)
        loss.backward()
        on_card = batch[0].is_cuda
        assert egnn_fused.pairwise_message_bwd.launches == before + \
            10 * on_card
        grads.append([loss.detach().cpu()] + [
            p.grad.cpu() for p in exp.model.parameters()])
    assert len(grads[0]) == 15
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        err = float((a - b).abs().max())
        assert err <= 1e-3 * max(1.0, float(b.abs().max())), err


@pytest.mark.cuda
def test_segno_rollout_matches_the_cpu(dev):
    """Two fed-back windows of the SEGNO rollout (20 launches of #1), card
    against the CPU, within 1e-3 x max(1, max|x|)."""
    outs = []
    for exp, batch in _segno_pair(dev, seed=1):
        before = egnn_fused.pairwise_message.launches
        x, e = exp.rollout(batch, 2, "charged")
        assert egnn_fused.pairwise_message.launches == before + \
            20 * x.is_cuda
        assert x.shape == (2, 32, 5, 3) and e.shape == (2, 32, 1)
        outs.append(x.cpu())
    assert torch.isfinite(outs[0]).all()
    err = float((outs[0] - outs[1]).abs().max())
    assert err <= 1e-3 * max(1.0, float(outs[1].abs().max())), err


def _seed_axis(k, b, n, e, clip, dev, h=64):
    """G = k x b graphs and k weight sets, stacked and one by one; N=31 on
    mocap's skeleton mask."""
    x, hi, hj, efea, mask, _ = _inputs(
        k * b, n, h, e, seed=n, dev=dev,
        isolated="skeleton" if n == 31 else None)
    sets = [_inputs(1, n, h, e, seed=n + 1 + s, dev=dev,
                    coord_scale=400.0 if clip else 1.0)[5]
            for s in range(k)]
    rng = np.random.RandomState(k)
    cot = tuple(torch.tensor(rng.randn(*s), dtype=torch.float32, device=dev)
                for s in ((k * b, n, 3), (k * b, n, h)))
    return (x, hi, hj, efea, mask), sets, cot


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,n,e,clip,h", [
    (5, 2560, 5, 2, False, 64),      # EGNO's fleet shape
    (5, 256, 5, 2, True, 64),        # SEGNO's, with the clip
    (3, 7, 5, 2, True, 64),          # a ragged tile per seed
    (2, 3, 64, 3, False, 64),        # graphs over several tiles, E=3
    (1, 9, 5, 2, False, 64),         # one stacked set
    (2, 30, 31, 1, True, 128),       # mocap's width and shape, two seeds
])
def test_seed_axis_kernels_give_the_bits_of_single_seed_launches(
        dev, k, b, n, e, clip, h):
    """#1 and #2 with k stacked weight sets over G = k x b graphs in one
    launch each: every output bitwise equal to one launch per seed (the
    weight-gradient slots keep each seed's block order), and within 1e-4 x
    max(1, max|plain|) of the plain seed-axis version."""
    nodes, sets, cot = _seed_axis(k, b, n, e, clip, dev, h)
    stacked = tuple(torch.stack(ws) for ws in zip(*sets))
    part = lambda t, s: t[s * b:(s + 1) * b]                    # noqa: E731
    before = (egnn_fused.pairwise_message.launches,
              egnn_fused.pairwise_message_bwd.launches)
    with torch.no_grad():
        fwd = egnn_fused.pairwise_message(clip, *nodes, stacked)
    bwd = egnn_fused.pairwise_message_bwd(clip, *nodes, stacked, *cot)
    assert (egnn_fused.pairwise_message.launches,
            egnn_fused.pairwise_message_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for s in range(k):
        one = (*(part(t, s) for t in nodes[:4]), nodes[4], sets[s])
        with torch.no_grad():
            f1 = egnn_fused.pairwise_message(clip, *one)
        b1 = egnn_fused.pairwise_message_bwd(
            clip, *one, *(part(c, s) for c in cot))
        for a, w in zip(fwd, f1):
            assert torch.equal(part(a, s), w)
        for a, w in zip(bwd[:4], b1[:4]):
            assert torch.equal(part(a, s), w)
        for a, w in zip(bwd[4], b1[4]):
            assert torch.equal(a[s], w)
    with torch.no_grad():
        _assert_close(fwd, egnn_fused.pairwise_message_seeds_reference(
            clip, *nodes, stacked))
    want = egnn_fused.pairwise_message_bwd_seeds_reference(
        clip, *nodes, stacked, *cot)
    _assert_close((*bwd[:4], *bwd[4]), (*want[:4], *want[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["egno", "segno"])
def test_fleet_step_on_the_card_matches_sequential_steps(dev, model):
    """Three Adam steps of a 3-seed fleet of the model_confs.yaml model on
    the card (#1/#2 once a layer or integrator step for all seeds) against
    each seed's own steps on the card: losses within 1e-4 relative (fp32
    batched over the seeds in other GEMM shapes), and each seed's Adam
    moments (exp_avg, exp_avg_sq) within 1e-3 of its own optimizer's in the
    norm of every leaf. The moments carry each step's gradient, and two
    seeds' differ by far more than that: a fleet that gave one seed
    another's gradient or Adam state fails here. The parameters are not
    compared: 3 Adam steps move each entry by at most about 3 lr, from the
    same start, whatever the gradients."""
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.main import build_experiment, get_args
    from nonode_tpu_torch.parallel.fleet import SeedFleet
    from nonode_tpu_torch.runtime import seed_everything

    args = get_args(["--model", model])
    build = lambda g: build_experiment(args, dev, g)              # noqa: E731
    seeds, b = [1, 2, 3], 64
    ds = NBodyDataset(Path(__file__).resolve().parents[1] / "data",
                      partition="train", max_samples=4 * b, device=dev)
    fleet = SeedFleet(build(seed_everything(seeds[0])), seeds)
    params, opt = fleet.init(lambda g: build(g).model)
    perms = np.stack([np.random.RandomState(s).permutation(4 * b)[:3 * b]
                      .reshape(3, b) for s in seeds])
    windows = fleet.exp.windows(ds, None, 3)     # one input: no draw
    before = (egnn_fused.pairwise_message.launches,
              egnn_fused.pairwise_message_bwd.launches)
    losses, _ = fleet.train_epoch(params, opt, ds, windows, perms)
    per = 4 if model == "egno" else 10
    assert (egnn_fused.pairwise_message.launches - before[0],
            egnn_fused.pairwise_message_bwd.launches - before[1]) == \
        (3 * per, 3 * per)
    moments = []                 # each seed's own exp_avg, all leaves
    for i, s in enumerate(seeds):
        exp = build(seed_everything(s))
        tl, _ = exp.train_epoch(ds, windows, perms[i])
        err = float((losses[i] - tl).abs().max())
        assert err <= 1e-4 * float(tl.abs().max()), err
        for name, p in exp.model.named_parameters():
            want, got = exp.optimizer.state[p], opt.state[params[name]]
            assert set(got) == set(want), name   # no state: no gradient
            if not want:
                continue
            assert int(got["step"]) == int(want["step"]) == 3
            for key in ("exp_avg", "exp_avg_sq"):
                ref = want[key]
                err = float((got[key][i] - ref).norm())
                assert err <= 1e-3 * float(ref.norm()), (name, key, err)
        moments.append(torch.cat([st["exp_avg"].ravel() for st in
                                  exp.optimizer.state.values() if st]))
    for i, j in [(0, 1), (1, 2), (0, 2)]:         # the check has teeth
        assert (moments[i] - moments[j]).norm() > 0.1 * moments[i].norm()


def _charged_state(n, dev, seed=0):
    loc, vel, _, q = ChargedSim(n_balls=n).init_state(
        torch.Generator().manual_seed(seed))
    return loc.to(dev), vel.to(dev), q.to(dev)


def _gravity_state(n, dev, seed=0):
    pos, vel, mass = (a.to(dev) for a in GravitySim(n_balls=n).init_state(
        torch.Generator().manual_seed(seed)))
    return pos, vel, pairwise.gravity_accel_reference(pos, mass), mass


def _one_wave():
    """The most senders one tile holds (a tile of a launch for more)."""
    return pairwise.launch_shape(10 ** 7)["senders_per_tile"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 129, 1000, 2500, "past one wave"])
def test_nbody_force_kernels_match_plain_versions(dev, n):
    """Every sender is staged in one wave while the senders fit a block's
    shared memory (2500 bodies take 40 KB); past that they come in tiles,
    each staged once for each group of receivers. Two launches give the
    same bits."""
    if n == "past one wave":
        n = _one_wave() + 37
        assert pairwise.launch_shape(n)["tiles"] == 2
    else:
        assert pairwise.launch_shape(n)["tiles"] == 1
    loc, _, q = _charged_state(n, dev, seed=n)
    pos, _, _, mass = _gravity_state(n, dev, seed=n)
    before = (pairwise.charged_force.launches, pairwise.gravity_accel.launches)
    got = (pairwise.charged_force(loc, q), pairwise.gravity_accel(pos, mass))
    again = (pairwise.charged_force(loc, q), pairwise.gravity_accel(pos, mass))
    torch.cuda.synchronize()
    assert (pairwise.charged_force.launches,
            pairwise.gravity_accel.launches) == (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_close(got, (pairwise.charged_force_reference(loc, q),
                        pairwise.gravity_accel_reference(pos, mass)))


@pytest.mark.cuda
def test_nbody_force_kernel_launch_shape(dev):
    """8 receivers to a 512-thread block, 2 warps each, so 1000 bodies are
    125 blocks; all senders in one tile up to what a block's shared memory
    holds (16 bytes a sender)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = pairwise.launch_shape(1000)
    assert shape == dict(blocks=min(125, 4 * sms), threads=512,
                         receivers_per_block=8, warps_per_receiver=2,
                         senders_per_tile=1000, tiles=1,
                         smem_bytes=shape["smem_bytes"])
    assert 16 * 1000 < shape["smem_bytes"] < 16 * 1000 + 256
    assert pairwise.launch_shape(1)["senders_per_tile"] == 1
    wave = _one_wave()
    assert wave % 64 == 0 and 10000 < wave and 16 * wave < 232448
    assert pairwise.launch_shape(wave)["tiles"] == 1
    assert pairwise.launch_shape(wave + 1)["tiles"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 1000, 2500])
def test_force_kernels_give_the_bits_of_a_micro_step(dev, n):
    """The force kernels sum in the block kernels' order with their laws:
    a one-step gravity block's acceleration is gravity_accel at its new
    positions, and a one-step charged block's kick is dt x charged_force
    at its recorded positions, bit for bit. 2500 bodies take three tiles of
    the block kernels' exchange and one wave of the force kernels'."""
    pos, vel, acc, mass = _gravity_state(n, dev, seed=n + 1)
    new_pos, _, new_acc = nbody_sim.gravity_leapfrog(pos, vel, acc, mass, 1)
    assert torch.equal(new_acc, pairwise.gravity_accel(new_pos, mass))
    loc, vel, q = _charged_state(n, dev, seed=n + 1)
    rec = (torch.empty_like(loc), torch.empty_like(vel))
    _, kicked = nbody_sim.charged_leapfrog(loc, vel, q, 1, record=rec)
    assert torch.equal(rec[0], loc + 0.001 * vel) and torch.equal(rec[1], vel)
    assert torch.equal(kicked, rec[1] + 0.001 * pairwise.charged_force(rec[0],
                                                                       q))


@pytest.mark.cuda
def test_recorded_blocks_give_the_bits_of_the_unfused_frames(dev):
    """Three frames of the stretch run's loop at N=1000: a 100-step block
    that records its last micro-step against the chain it replaces (a
    99-step block, the drift on the host's stream, the record, the force
    kernel, the kick). The recorded launch's outputs are those of a
    100-step launch without records."""
    loc, vel, q = _charged_state(1000, dev, seed=4)
    fused, chain = (loc, vel), (loc, vel)
    for _ in range(3):
        rec = (torch.empty_like(loc), torch.empty_like(vel))
        plain_block = nbody_sim.charged_leapfrog(*fused, q, 100)
        fused = nbody_sim.charged_leapfrog(*fused, q, 100, record=rec)
        assert all(torch.equal(a, b) for a, b in zip(fused, plain_block))
        p, v = nbody_sim.charged_leapfrog(*chain, q, 99)
        p = p + 0.001 * v
        assert torch.equal(rec[0], p) and torch.equal(rec[1], v)
        chain = (p, v + 0.001 * pairwise.charged_force(p, q))
        assert all(torch.equal(a, b) for a, b in zip(fused, chain))


@pytest.mark.cuda
@pytest.mark.parametrize("n,steps", [(1, 3), (5, 99), (129, 20), (1000, 99),
                                     (2500, 5), (4097, 3)])
def test_leapfrog_kernels_match_plain_versions_and_repeat(dev, n, steps):
    """Each block kernel against its plain version; two launches give the
    same bits (fixed-order sums, no atomics). 2500 bodies stage their
    senders in three tiles, 4097 in five, the last of one body."""
    loc, vel, q = _charged_state(n, dev, seed=n)
    got = nbody_sim.charged_leapfrog(loc, vel, q, steps)
    again = nbody_sim.charged_leapfrog(loc, vel, q, steps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_close(got, nbody_sim.charged_leapfrog_reference(loc, vel, q,
                                                            steps))
    state = _gravity_state(n, dev, seed=n)
    got = nbody_sim.gravity_leapfrog(*state, steps + 1)
    again = nbody_sim.gravity_leapfrog(*state, steps + 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_close(got, nbody_sim.gravity_leapfrog_reference(*state,
                                                            steps + 1))


@pytest.mark.cuda
def test_leapfrog_kernels_take_more_bodies_than_resident_warps(dev):
    """Past what the cooperative grid covers in one pass, each block owns
    its receivers in several passes."""
    cap = nbody_sim.launch_shape(10 ** 5)["blocks"]
    n = nbody_sim.launch_shape(1)["receivers_per_pass"] * cap + 37
    shape = nbody_sim.launch_shape(n)
    assert (shape["blocks"], shape["passes"]) == (cap, 2)
    loc, vel, q = _charged_state(n, dev, seed=1)
    got = nbody_sim.charged_leapfrog(loc, vel, q, 2)
    _assert_close(got, nbody_sim.charged_leapfrog_reference(loc, vel, q, 2))
    state = _gravity_state(n, dev, seed=1)
    got = nbody_sim.gravity_leapfrog(*state, 2)
    _assert_close(got, nbody_sim.gravity_leapfrog_reference(*state, 2))


@pytest.mark.cuda
def test_leapfrog_block_gives_the_bits_of_single_steps(dev):
    """One launch of 99 micro-steps against 99 launches of one: the fused
    kick and drift and the exchange between SMs change no arithmetic."""
    loc, vel, q = _charged_state(1000, dev, seed=3)
    block = nbody_sim.charged_leapfrog(loc, vel, q, 99)
    steps = (loc, vel)
    for _ in range(99):
        steps = nbody_sim.charged_leapfrog(*steps, q, 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(block, steps))
    pos, vel, acc, mass = _gravity_state(1000, dev, seed=3)
    block = nbody_sim.gravity_leapfrog(pos, vel, acc, mass, 99)
    steps = (pos, vel, acc)
    for _ in range(99):
        steps = nbody_sim.gravity_leapfrog(*steps, mass, 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(block, steps))


@pytest.mark.cuda
def test_leapfrog_launch_shape_and_probe(dev):
    """One 512-thread block per 8 receivers up to one per SM; the probe
    runs every scheme without counting a launch of the kernels."""
    shape = nbody_sim.launch_shape(1000)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert shape == dict(blocks=min(125, sms), threads=512,
                         receivers_per_pass=8, warps_per_receiver=2,
                         passes=1 if sms >= 125 else 2,
                         smem_bytes=shape["smem_bytes"])
    loc, vel, q = _charged_state(1000, dev, seed=2)
    before = nbody_sim.charged_leapfrog.launches
    for scheme in nbody_sim.PROBE_SCHEMES:
        out = nbody_sim.leapfrog_probe(loc, vel, q, 9, scheme=scheme)
        torch.cuda.synchronize()
        assert all(a.shape == loc.shape for a in out)
    assert nbody_sim.charged_leapfrog.launches == before
    with pytest.raises(ValueError, match="scheme=0"):
        nbody_sim.leapfrog_probe(loc, vel, q, 9, scheme=0)


@pytest.mark.cuda
def test_nbody_wrappers_refuse_what_the_kernels_do_not_take(dev):
    loc, vel, q = _charged_state(8, dev)
    with pytest.raises(ValueError, match="at least one micro-step"):
        nbody_sim.charged_leapfrog(loc, vel, q, 0)
    with pytest.raises(TypeError, match="float32"):
        pairwise.charged_force(loc.double(), q)
    with pytest.raises(ValueError, match="not contiguous"):
        pairwise.gravity_accel(loc.T.contiguous().T, q.abs())
    with pytest.raises(ValueError, match="vel has shape"):
        nbody_sim.charged_leapfrog(loc, vel[:4], q, 1)
    with pytest.raises(ValueError, match="rec_pos is on cpu"):
        nbody_sim.charged_leapfrog(loc, vel, q, 1,
                                   record=(loc.cpu(), torch.empty_like(vel)))
    with pytest.raises(ValueError, match="rec_vel is not contiguous"):
        nbody_sim.charged_leapfrog(loc, vel, q, 1, record=(
            torch.empty_like(loc), torch.empty(3, 8, device=dev).T))
    with pytest.raises(ValueError, match="on cpu"):
        pairwise.charged_force(loc, q.cpu())
    # more bodies than the owners' state fits in shared memory
    big = 10 ** 7
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        nbody_sim.charged_leapfrog(torch.zeros(big, 3, device=dev),
                                   torch.zeros(big, 3, device=dev),
                                   torch.ones(big, device=dev), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("t_steps,modes", [(2, 2), (4, 3), (10, 2)])
def test_spectral_conv_on_the_card_matches_the_cpu(dev, t_steps, modes):
    """With even T and modes > T/2 the last kept mode is the Nyquist term:
    its imaginary part is dropped before cuFFT's c2r, as the CPU's irfft
    drops it. Forward and weights1 gradient, card against CPU."""
    conv = SpectralConv(6, 6, modes, device="cpu",
                        generator=torch.Generator().manual_seed(t_steps))
    card = SpectralConv(6, 6, modes, device=dev)
    card.load_state_dict(conv.state_dict())
    rng = np.random.RandomState(modes)
    x = torch.tensor(rng.randn(t_steps, 3, 4, 6), dtype=torch.float32)
    ct = torch.tensor(rng.randn(t_steps, 3, 4, 6), dtype=torch.float32)
    outs = []
    for module, where in ((conv, "cpu"), (card, dev)):
        y = module(x.to(where))
        (y * ct.to(where)).sum().backward()
        outs.append((y.detach().cpu(), module.weights1.grad.cpu()))
    _assert_close(outs[1], outs[0])


@pytest.mark.cuda
def test_phase_timer_waits_for_the_card(dev):
    """A phase whose block_on holds a CUDA tensor (in a list the body
    fills) closes only when the card has done the work queued in it: about
    20 ms of torch.cuda._sleep, which the host enqueues in microseconds."""
    from nonode_tpu_torch.utils.profiling import PhaseTimer

    torch.cuda.synchronize(dev)
    timer = PhaseTimer()
    out = []
    with timer.phase("sleep", block_on=out):
        torch.cuda._sleep(40_000_000)
        out.append({"x": [torch.ones(1, device=dev)]})
    assert torch.cuda.current_stream(dev).query()
    assert timer.totals["sleep"] > 5e-3
