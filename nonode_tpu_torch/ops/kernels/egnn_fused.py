"""Fused pairwise-message chain of the EGNN/SEGNO layers: CUDA forward and
backward kernels (``csrc/egnn_fused_fwd.cu``, ``csrc/egnn_fused_bwd.cu``)
joined by a ``torch.autograd.Function``, with the plain PyTorch version of
each beside it.

Counterpart of nonode_tpu/ops/pallas/egnn_fused.py:pairwise_message (the
custom-VJP op over ``_fwd_kernel`` and ``_bwd_kernel``). The chain, per edge
(i, j) of each graph:

    pre1  = r2 * wg + h_i + h_j + e_fea @ We + b1           [.., N, N, H]
    msg   = silu(silu(pre1) @ W2 + b2)                      [.., N, N, H]
    cw    = silu(msg @ Wc1 + bc1) @ wc2 + bc2               [.., N, N, 1]
    f     = (x_i - x_j) * cw      (clipped per edge iff clip_edges)
    tot_f = masked_mean_j(f)                                [.., N, 3]
    tot_m = masked_sum_j(msg)                               [.., N, H]

The backward recomputes the chain from the inputs (the only residuals, as
``_pm_fwd`` keeps them) and returns the gradients of x, hi, hj, efea and the
nine weights; the mask gets none. Both directions take the plain version
for CPU tensors only. For CUDA tensors they launch the kernel or raise; they
never fall back.

Receiver slice. A call may take the receivers [i0, i0 + ni) of every graph
against all N senders: x and hj hold all N nodes, hi, efea and the mask the
slice's rows (``i0`` given, ``ni`` from hi), and the outputs are the slice's
rows. The backward's dx and dhj then hold the slice's contributions to
every node, which the slices' ranks sum (parallel/mesh.py: the particle axis
sharded over ``--space``, as the JAX package shards the receiver axis of the
dense tensors). ``i0 = 0`` with ni = N is the whole graph.

Seed axis. The weights may also come as K stacked sets ([K, ...] each) over
G = K * B graphs: graph g reads set g // B, and the mask stays shared. One
launch of each kernel then serves K seeds, which is what ``jax.vmap`` of the
custom-VJP op computes in nonode_tpu's seed fleet. Under ``torch.vmap`` the
op's vmap rule folds the vmapped axis into that seed axis, so a fleet that
vmaps the ordinary modules over stacked parameters (parallel/fleet.py)
launches each kernel once per call for all its seeds. A slice other than the
whole graph takes one weight set.

Widths. The kernels are instantiated for H = 64 and H = 128. Any other width
up to 128 runs on them zero-padded (``pad_width``): hi, hj and the weights
take zero columns (and W2, Wc1, wc2 zero rows) up to the next instantiated
width, and the outputs and gradients are cut back (``cut_width``). This is
exact: a padded unit's pre-activation is 0 and SiLU(0) = 0, so it is 0 in
the forward, the zero rows keep it from every real unit, its upstream
gradient is 0 in the backward, and zeros split exactly into TF32 halves.
A width above 128 raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load

SOURCE = "egnn_fused_fwd.cu"
BWD_SOURCE = "egnn_fused_bwd.cu"
CLIP = 100.0
# the widths the kernels are instantiated for; any other H <= MAX_HIDDEN is
# zero-padded to the next of them (``padded_width``), a larger one raises
HIDDEN = (64, 128)
MAX_HIDDEN = HIDDEN[-1]
MAX_NODES = 64            # N * N <= 4096, as the TPU kernel's gate
MAX_EDGE_FEATURES = 4     # E the kernels keep in registers

# weights tuple layout (all pre-transposed to [in, out] / row vectors):
#   wg [1,H], we [E,H], b1 [1,H], w2 [H,H], b2 [1,H],
#   wc1 [H,H], bc1 [1,H], wc2 [H,1], bc2 [1,1]
N_WEIGHTS = 9


def supported(n: int, hidden: int, dtype, act, flat: bool, norm: bool,
              tanh: bool = False) -> bool:
    """Config gate, the TPU kernel's (nonode_tpu/ops/pallas/egnn_fused.py:
    355-360). It has no width limit: on the card the widths in ``HIDDEN``
    run on their own instantiation, every other width up to ``MAX_HIDDEN``
    runs zero-padded to the next one, and a width above it raises in
    ``pairwise_message``."""
    from ...nn import silu
    return (dtype == torch.float32 and not flat and not norm and not tanh
            and act is silu and n <= MAX_NODES)


def pairwise_message_reference(clip_edges, x, hi, hj, efea, mask, weights,
                               i0=0):
    """Plain PyTorch version of the chain on dense [G, ni, N, H] tensors:
    the receivers [i0, i0 + ni) against all N senders."""
    wg, we, b1, w2, b2, wc1, bc1, wc2, bc2 = weights
    xr = x[:, i0:i0 + hi.shape[1]]
    rij = xr[:, :, None, :] - x[:, None, :, :]                # [G,ni,N,3]
    r2 = (rij * rij).sum(-1, keepdim=True)                    # [G,N,N,1]
    pre1 = r2 * wg + efea @ we
    pre1 = pre1 + hi[:, :, None, :] + hj[:, None, :, :] + b1
    msg = F.silu(F.silu(pre1) @ w2 + b2)
    cw = F.silu(msg @ wc1 + bc1) @ wc2 + bc2                  # [G,N,N,1]
    f = rij * cw
    if clip_edges:
        f = f.clamp(-CLIP, CLIP)
    m = mask[..., None]
    deg = mask.sum(-1, keepdim=True).clamp(min=1.0)           # [ni,1]
    return (f * m).sum(-2) / deg, (msg * m).sum(-2)


def _dsilu(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def pairwise_message_bwd_reference(clip_edges, x, hi, hj, efea, mask, weights,
                                   gtotf, gtotm, i0=0):
    """Plain PyTorch version of the chain's backward (``_bwd_kernel``,
    nonode_tpu/ops/pallas/egnn_fused.py:147-216): recomputes the chain and
    returns (dx, dhi, dhj, defea, dweights) in the primal layouts, dwc2 as
    [H,1]. With clip_edges, edges whose force left the clip (or is NaN) pass
    no gradient through it. On a receiver slice, dx and dhj hold the slice's
    contributions to all N nodes."""
    wg, we, b1, w2, b2, wc1, bc1, wc2, bc2 = weights
    ni = hi.shape[1]
    xr = x[:, i0:i0 + ni]
    rij = xr[:, :, None, :] - x[:, None, :, :]                # [G,ni,N,3]
    r2 = (rij * rij).sum(-1, keepdim=True)                    # [G,N,N,1]
    pre1 = r2 * wg + efea @ we
    pre1 = pre1 + hi[:, :, None, :] + hj[:, None, :, :] + b1
    a1 = F.silu(pre1)
    pre2 = a1 @ w2 + b2
    msg = F.silu(pre2)
    cpre = msg @ wc1 + bc1
    ca = F.silu(cpre)
    cw = ca @ wc2 + bc2                                       # [G,N,N,1]
    f = rij * cw
    deg = mask.sum(-1, keepdim=True).clamp(min=1.0)           # [ni,1]
    gf = gtotf[:, :, None, :] * (mask / deg)[..., None]       # [G,ni,N,3]
    if clip_edges:
        gf = gf * (f.abs() <= CLIP).to(f.dtype)
    dcw = (gf * rij).sum(-1, keepdim=True)                    # [G,N,N,1]
    drij = gf * cw
    dcpre = dcw * wc2.T * _dsilu(cpre)
    dmsg = dcpre @ wc1.T + gtotm[:, :, None, :] * mask[..., None]
    dpre2 = dmsg * _dsilu(pre2)
    dpre1 = (dpre2 @ w2.T) * _dsilu(pre1)
    drij = drij + 2.0 * rij * (dpre1 @ wg.T)
    dx = -drij.sum(1)                                         # senders
    dx[:, i0:i0 + ni] += drij.sum(2)                          # receivers
    rows = lambda t: t.reshape(-1, t.shape[-1])               # noqa: E731
    dweights = (
        (rows(r2) * rows(dpre1)).sum(0, keepdim=True),        # dwg  [1,H]
        rows(efea).T @ rows(dpre1),                           # dwe  [E,H]
        rows(dpre1).sum(0, keepdim=True),                     # db1  [1,H]
        rows(a1).T @ rows(dpre2),                             # dw2  [H,H]
        rows(dpre2).sum(0, keepdim=True),                     # db2  [1,H]
        rows(msg).T @ rows(dcpre),                            # dwc1 [H,H]
        rows(dcpre).sum(0, keepdim=True),                     # dbc1 [1,H]
        (rows(ca) * rows(dcw)).sum(0)[:, None],               # dwc2 [H,1]
        rows(dcw).sum().reshape(1, 1))                        # dbc2 [1,1]
    return dx, dpre1.sum(2), dpre1.sum(1), dpre1 @ we.T, dweights


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if name in ("hi", "hj", "w2", "wc1") and t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (read in 16-byte "
                         f"pieces)")


def seeds_of(weights) -> int | None:
    """K when the nine weights are K stacked sets ([K, ...] each), None for
    one set."""
    return weights[0].shape[0] if weights[0].dim() == 3 else None


def receiver_slice(x, hi, i0, weights) -> int:
    """ni, the receivers of a call's slice [i0, i0 + ni) of the N in x;
    raises on a slice out of range, or with stacked weights on a slice that
    is not the whole graph."""
    n, ni = x.shape[1], hi.shape[1]
    if not (0 <= i0 and 1 <= ni and i0 + ni <= n):
        raise ValueError(f"receiver slice [{i0}, {i0 + ni}) out of N={n}")
    if ni != n and seeds_of(weights) is not None:
        raise ValueError("a receiver slice takes one weight set, not stacked "
                         "weights")
    return ni


def _checked_inputs(x, hi, hj, efea, mask, weights, i0):
    """The launch's shapes (g, n, h, e, k, ni) and contiguous weights,
    after checking every input; k = 1 for one weight set, ni the receiver
    slice's rows. Raises on what the kernels do not take."""
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    ni = receiver_slice(x, hi, i0, weights)
    g, n, _ = x.shape
    h = hi.shape[-1]
    e = efea.shape[-1]
    if not 1 <= h <= MAX_HIDDEN or not 1 <= n <= MAX_NODES \
            or not 1 <= e <= MAX_EDGE_FEATURES:
        raise ValueError(f"unsupported shape: N={n}, H={h}, E={e} "
                         f"(kernel takes N<={MAX_NODES}, H<={MAX_HIDDEN}: "
                         f"H in {HIDDEN} natively, others zero-padded, "
                         f"1<=E<={MAX_EDGE_FEATURES})")
    k = seeds_of(weights)
    lead = () if k is None else (k,)
    if k is not None and (k < 1 or g % k):
        raise ValueError(f"{g} graphs do not split over {k} weight sets")
    weights = tuple(w.contiguous() for w in weights)
    dev = x.device
    for name, t, shape in (
            ("x", x, (g, n, 3)), ("hi", hi, (g, ni, h)), ("hj", hj, (g, n, h)),
            ("efea", efea, (g, ni, n, e)), ("mask", mask, (ni, n)),
            *zip(("wg", "we", "b1", "w2", "b2", "wc1", "bc1", "wc2", "bc2"),
                 weights, (lead + s for s in _weight_shapes(h, e)))):
        _check(name, t, shape, dev)
    return (g, n, h, e, k or 1, ni), weights


def _weight_shapes(h, e):
    return ((1, h), (e, h), (1, h), (h, h), (1, h), (h, h), (1, h), (h, 1),
            (1, 1))


def padded_width(h: int) -> int:
    """The instantiated width that H runs at: H itself in ``HIDDEN``, else
    the next one up; raises above ``MAX_HIDDEN``."""
    for hp in HIDDEN:
        if 1 <= h <= hp:
            return hp
    raise ValueError(f"unsupported width H={h}: the kernels take "
                     f"1<=H<={MAX_HIDDEN} (H in {HIDDEN} natively)")


def pad_width(weights, hi, hj, hp):
    """(weights, hi, hj) of width H zero-padded to width ``hp``: hi and hj
    (columns H..hp), wg, we, b1, b2, bc1 (entries H..hp), w2 and wc1 (rows
    and columns H..hp) and wc2 (rows H..hp); bc2 as it is. One weight set
    or K stacked; the tensors come back contiguous."""
    h = hi.shape[-1]
    e = weights[1].shape[-2]

    def grow(t, shape, want):
        return F.pad(t, (0, want[1] - shape[1], 0, want[0] - shape[0])) \
            .contiguous()

    padded = tuple(grow(w, s, ps) for w, s, ps in zip(
        weights, _weight_shapes(h, e), _weight_shapes(hp, e)))
    return padded, grow(hi, (0, h), (0, hp)), grow(hj, (0, h), (0, hp))


def cut_width(h, e, hidden=(), dweights=()):
    """The inverse of ``pad_width`` on a padded call's outputs: the
    hidden-width tensors (tot_m; dhi, dhj) cut to their first H columns and
    the nine weight gradients to the weights' shapes at width H (one set or
    K stacked). Returns (hidden, dweights)."""
    return (tuple(t[..., :h].contiguous() for t in hidden),
            tuple(d[..., :r, :c].contiguous()
                  for d, (r, c) in zip(dweights, _weight_shapes(h, e))))


def _per_seed(k, t):
    """[K * B, ...] -> [K, B, ...]."""
    return t.reshape(k, t.shape[0] // k, *t.shape[1:])


def pairwise_message_seeds_reference(clip_edges, x, hi, hj, efea, mask,
                                     weights):
    """Plain seed-axis version: ``pairwise_message_reference`` vmapped over
    K stacked weight sets, graph g on set g // B."""
    k = seeds_of(weights)
    one = lambda x, hi, hj, efea, *w: pairwise_message_reference(  # noqa: E731
        clip_edges, x, hi, hj, efea, mask, w)
    totf, totm = torch.func.vmap(one)(
        *(_per_seed(k, a) for a in (x, hi, hj, efea)), *weights)
    return totf.flatten(0, 1), totm.flatten(0, 1)


def pairwise_message_bwd_seeds_reference(clip_edges, x, hi, hj, efea, mask,
                                         weights, gtotf, gtotm):
    """Plain seed-axis backward: ``pairwise_message_bwd_reference`` vmapped
    over the K weight sets; the weight gradients come stacked [K, ...]."""
    k = seeds_of(weights)
    one = lambda x, hi, hj, efea, gf, gm, *w: \
        pairwise_message_bwd_reference(                      # noqa: E731
            clip_edges, x, hi, hj, efea, mask, w, gf, gm)
    dx, dhi, dhj, defea, dweights = torch.func.vmap(one)(
        *(_per_seed(k, a) for a in (x, hi, hj, efea, gtotf, gtotm)),
        *weights)
    return (dx.flatten(0, 1), dhi.flatten(0, 1), dhj.flatten(0, 1),
            defea.flatten(0, 1), tuple(dweights))


def _bind_fwd():
    fn = load(SOURCE).egnn_pairwise_fwd
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bind_bwd():
    lib = load(BWD_SOURCE)
    fn = lib.egnn_pairwise_bwd
    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.egnn_pairwise_bwd_scratch_floats
    scratch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def pairwise_message_fwd(clip_edges, x, hi, hj, efea, mask, weights, i0=0):
    """(tot_f, tot_m) without autograd: the forward kernel for CUDA tensors,
    the plain version for CPU tensors. ``weights``: one set or K stacked;
    the receivers [i0, i0 + ni) of each graph (ni from hi)."""
    if x.device.type == "cpu":
        receiver_slice(x, hi, i0, weights)
        if seeds_of(weights) is not None:
            return pairwise_message_seeds_reference(clip_edges, x, hi, hj,
                                                    efea, mask, weights)
        return pairwise_message_reference(clip_edges, x, hi, hj, efea, mask,
                                          weights, i0)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_message: unsupported device {x.device}")
    (g, n, h, e, k, ni), weights = _checked_inputs(x, hi, hj, efea, mask,
                                                   weights, i0)
    hp = padded_width(h)
    if hp != h:
        weights, hi, hj = pad_width(weights, hi, hj, hp)
    dev = x.device
    totf = torch.empty((g, ni, 3), dtype=torch.float32, device=dev)
    totm = torch.empty((g, ni, hp), dtype=torch.float32, device=dev)
    if g > 0:
        fn = _bind_fwd()
        with torch.cuda.device(dev):
            err = fn(*(t.data_ptr() for t in (x, hi, hj, efea, mask,
                                              *weights, totf, totm)),
                     g, n, hp, e, k, int(bool(clip_edges)), ni, i0,
                     _stream(dev))
        if err != 0:
            raise RuntimeError(
                f"egnn_pairwise_fwd launch failed: cudaError {err}")
        pairwise_message.launches += 1
    if hp != h:
        (totm,), _ = cut_width(h, e, (totm,))
    return totf, totm


def pairwise_message_bwd(clip_edges, x, hi, hj, efea, mask, weights, gtotf,
                         gtotm, i0=0):
    """(dx, dhi, dhj, defea, dweights) of the chain for the cotangents
    (gtotf, gtotm): the backward kernel for CUDA tensors (its two launches,
    the persistent blocks' pass and the fixed-order sum of their partial
    weight gradients, count as one), the plain version for CPU tensors.
    With K stacked weight sets the weight gradients come stacked too. On a
    receiver slice [i0, i0 + ni), dx and dhj hold the slice's contributions
    to all N nodes."""
    if x.device.type == "cpu":
        receiver_slice(x, hi, i0, weights)
        if seeds_of(weights) is not None:
            return pairwise_message_bwd_seeds_reference(
                clip_edges, x, hi, hj, efea, mask, weights, gtotf, gtotm)
        return pairwise_message_bwd_reference(
            clip_edges, x, hi, hj, efea, mask, weights, gtotf, gtotm, i0)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_message: unsupported device {x.device}")
    stacked = seeds_of(weights) is not None
    (g, n, h, e, k, ni), weights = _checked_inputs(x, hi, hj, efea, mask,
                                                   weights, i0)
    dev = x.device
    _check("gtotf", gtotf, (g, ni, 3), dev)
    _check("gtotm", gtotm, (g, ni, h), dev)
    hp = padded_width(h)
    if hp != h:
        weights, hi, hj = pad_width(weights, hi, hj, hp)
        gtotm = F.pad(gtotm, (0, hp - h))
    dx = torch.empty((g, n, 3), dtype=torch.float32, device=dev)
    dhi = torch.empty((g, ni, hp), dtype=torch.float32, device=dev)
    dhj = torch.empty((g, n, hp), dtype=torch.float32, device=dev)
    defea = torch.empty((g, ni, n, e), dtype=torch.float32, device=dev)
    shapes = _weight_shapes(hp, e)
    # the kernel's flat layout: dw2, dwc1, dwg, db1, db2, dbc1, dwc2, dwe, dbc2
    order = (3, 5, 0, 2, 4, 6, 7, 1, 8)
    np_ = 2 * hp * hp + 5 * hp + e * hp + 1
    flat = torch.zeros((k, np_), dtype=torch.float32, device=dev)
    if g > 0:
        fn, scratch_floats = _bind_bwd()
        with torch.cuda.device(dev):
            # one slot per block of the launch's grid on this device
            size = scratch_floats(g, n, hp, e, k, ni)
            if size < 0:
                raise RuntimeError("egnn_pairwise_bwd: no launch grid for "
                                   f"N={n}, H={hp}, E={e} on {dev}")
            scratch = torch.empty(size, dtype=torch.float32, device=dev)
            err = fn(*(t.data_ptr() for t in (
                x, hi, hj, efea, mask, *weights, gtotf, gtotm, dx, dhi, dhj,
                defea, flat, scratch)),
                g, n, hp, e, k, int(bool(clip_edges)), ni, i0, _stream(dev))
        if err != 0:
            raise RuntimeError(
                f"egnn_pairwise_bwd launch failed: cudaError {err}")
        pairwise_message_bwd.launches += 1
    dweights = [None] * N_WEIGHTS
    off = 0
    for w in order:
        size = shapes[w][0] * shapes[w][1]
        part = flat[:, off:off + size].view(k, *shapes[w])
        dweights[w] = part if stacked else part[0]
        off += size
    if hp != h:
        (dhi, dhj), dweights = cut_width(h, e, (dhi, dhj), dweights)
    return dx, dhi, dhj, defea, tuple(dweights)


class _PairwiseMessage(torch.autograd.Function):
    """The custom-VJP op (``_pm_fwd`` / ``_pm_bwd``): the forward keeps only
    the inputs as residuals, the backward recomputes the chain. The nine
    weights are separate arguments, so that autograd tracks each one; they
    are one set, or K stacked sets over G = K * B graphs. ``i0`` is the
    receiver slice's first row.

    Its vmap rule (``torch.vmap``, as ``jax.vmap`` of the Pallas op) folds
    the vmapped axis into the seed axis: every vmapped input moves it first,
    an input that is not vmapped is broadcast over it, and the one call of
    the seed-axis op launches each kernel once for the whole vmap."""

    @staticmethod
    def forward(clip_edges, i0, x, hi, hj, efea, mask, *weights):
        return pairwise_message_fwd(clip_edges, x, hi, hj, efea, mask,
                                    weights, i0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        clip_edges, i0, *tensors = inputs
        ctx.clip_edges = clip_edges
        ctx.i0 = i0
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, gtotf, gtotm):
        x, hi, hj, efea, mask, *weights = ctx.saved_tensors
        dx, dhi, dhj, defea, dweights = pairwise_message_bwd(
            ctx.clip_edges, x, hi, hj, efea, mask, tuple(weights),
            gtotf.contiguous(), gtotm.contiguous(), ctx.i0)
        grads = (dx, dhi, dhj, defea, None, *dweights)
        return (None, None, *(gr if need else None for gr, need in
                              zip(grads, ctx.needs_input_grad[2:])))

    @staticmethod
    def vmap(info, in_dims, clip_edges, i0, x, hi, hj, efea, mask, *weights):
        in_dims = in_dims[1:]        # x at 1, the mask at 5, the weights from 6
        if in_dims[5] is not None:
            raise ValueError("pairwise_message: the mask is shared by every "
                             "seed; it cannot be vmapped")
        k = info.batch_size

        def seeds(t, d):
            return t.movedim(d, 0) if d is not None else t.expand(k, *t.shape)

        if weights[0].dim() - (in_dims[6] is not None) != 2:
            raise ValueError("pairwise_message: vmap over stacked weights")
        nodes = [seeds(t, d) for t, d in zip((x, hi, hj, efea), in_dims[1:5])]
        g = nodes[0].shape[1]
        flat = [t.reshape(k * g, *t.shape[2:]).contiguous() for t in nodes]
        ws = [seeds(w, d).contiguous() for w, d in zip(weights, in_dims[6:])]
        totf, totm = _PairwiseMessage.apply(clip_edges, i0, *flat, mask, *ws)
        return (totf.view(k, g, *totf.shape[1:]),
                totm.view(k, g, *totm.shape[1:])), (0, 0)


def pairwise_message(clip_edges, x, hi, hj, efea, mask, weights, i0=0):
    """(tot_f, tot_m) [G,ni,.] of the fused pairwise chain on the
    receivers [i0, i0 + ni) of each graph, differentiable in every input but
    the mask.

    x [G,N,3]; hi [G,ni,H], hj [G,N,H] (node features projected by the Wi/Wj
    column slices of the first edge-MLP Linear); efea [G,ni,N,E]; mask
    [ni,N] 0/1, the slice's rows of an [N,N] mask with zero diagonal;
    weights: the 9-tuple above in [in,out] layout, or K such sets stacked
    [K, ...] over G = K * B graphs (graph g on set g // B, the whole graph
    only). ni = N, i0 = 0: the whole graph.
    """
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    return _PairwiseMessage.apply(bool(clip_edges), int(i0), x, hi, hj, efea,
                                  mask, *weights)


pairwise_message.launches = 0
pairwise_message_bwd.launches = 0
