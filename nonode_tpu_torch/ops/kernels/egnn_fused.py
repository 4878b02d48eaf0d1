"""Fused pairwise-message chain of the EGNN/SEGNO layers: CUDA forward kernel
(``csrc/egnn_fused_fwd.cu``) and its plain PyTorch version.

Counterpart of nonode_tpu/ops/pallas/egnn_fused.py:pairwise_message (forward,
``_fwd_kernel``). The chain, per edge (i, j) of each graph:

    pre1  = r2 * wg + h_i + h_j + e_fea @ We + b1           [.., N, N, H]
    msg   = silu(silu(pre1) @ W2 + b2)                      [.., N, N, H]
    cw    = silu(msg @ Wc1 + bc1) @ wc2 + bc2               [.., N, N, 1]
    f     = (x_i - x_j) * cw      (clipped per edge iff clip_edges)
    tot_f = masked_mean_j(f)                                [.., N, 3]
    tot_m = masked_sum_j(msg)                               [.., N, H]

``pairwise_message`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises; it never falls back. The backward
kernel is not ported yet, so a CUDA call that would need gradients raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load

SOURCE = "egnn_fused_fwd.cu"
CLIP = 100.0
HIDDEN = (64,)            # widths the kernel is instantiated for
MAX_NODES = 64            # N * N <= 4096, as the TPU kernel's gate

# weights tuple layout (all pre-transposed to [in, out] / row vectors):
#   wg [1,H], we [E,H], b1 [1,H], w2 [H,H], b2 [1,H],
#   wc1 [H,H], bc1 [1,H], wc2 [H,1], bc2 [1,1]
N_WEIGHTS = 9


def supported(n: int, hidden: int, dtype, act, flat: bool, norm: bool,
              tanh: bool = False) -> bool:
    """Config gate, the TPU kernel's (nonode_tpu/ops/pallas/egnn_fused.py:
    355-360). It has no width limit: on the card a width the kernel is not
    instantiated for raises in ``pairwise_message``."""
    from ...nn import silu
    return (dtype == torch.float32 and not flat and not norm and not tanh
            and act is silu and n <= MAX_NODES)


def pairwise_message_reference(clip_edges, x, hi, hj, efea, mask, weights):
    """Plain PyTorch version of the chain on dense [G, N, N, H] tensors."""
    wg, we, b1, w2, b2, wc1, bc1, wc2, bc2 = weights
    rij = x[:, :, None, :] - x[:, None, :, :]                 # [G,N,N,3]
    r2 = (rij * rij).sum(-1, keepdim=True)                    # [G,N,N,1]
    pre1 = r2 * wg + efea @ we
    pre1 = pre1 + hi[:, :, None, :] + hj[:, None, :, :] + b1
    msg = F.silu(F.silu(pre1) @ w2 + b2)
    cw = F.silu(msg @ wc1 + bc1) @ wc2 + bc2                  # [G,N,N,1]
    f = rij * cw
    if clip_edges:
        f = f.clamp(-CLIP, CLIP)
    m = mask[..., None]
    deg = mask.sum(-1, keepdim=True).clamp(min=1.0)           # [N,1]
    return (f * m).sum(-2) / deg, (msg * m).sum(-2)


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
    if name in ("hi", "hj") and t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (read as float4)")


def _bind():
    lib = load(SOURCE)
    fn = lib.egnn_pairwise_fwd
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def pairwise_message(clip_edges, x, hi, hj, efea, mask, weights):
    """(tot_f, tot_m) of the fused pairwise chain.

    x [G,N,3]; hi/hj [G,N,H] (node features projected by the Wi/Wj column
    slices of the first edge-MLP Linear); efea [G,N,N,E]; mask [N,N] 0/1 with
    zero diagonal; weights: the 9-tuple above in [in,out] layout.
    """
    if x.device.type == "cpu":
        return pairwise_message_reference(clip_edges, x, hi, hj, efea, mask,
                                          weights)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_message: unsupported device {x.device}")
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, hi, hj, efea, *weights)):
        raise NotImplementedError(
            "pairwise_message on CUDA is forward-only: the backward kernel "
            "comes with ROADMAP.md Queue 1 'EGNO training slice'; call it "
            "under torch.no_grad()")
    g, n, _ = x.shape
    h = hi.shape[-1]
    e = efea.shape[-1]
    if h not in HIDDEN or not 1 <= n <= MAX_NODES or e < 1:
        raise ValueError(f"unsupported shape: N={n}, H={h}, E={e} "
                         f"(kernel takes N<={MAX_NODES}, H in {HIDDEN}, E>=1)")
    dev = x.device
    wg, we, b1, w2, b2, wc1, bc1, wc2, bc2 = (w.contiguous() for w in weights)
    for name, t, shape in (
            ("x", x, (g, n, 3)), ("hi", hi, (g, n, h)), ("hj", hj, (g, n, h)),
            ("efea", efea, (g, n, n, e)), ("mask", mask, (n, n)),
            ("wg", wg, (1, h)), ("we", we, (e, h)), ("b1", b1, (1, h)),
            ("w2", w2, (h, h)), ("b2", b2, (1, h)), ("wc1", wc1, (h, h)),
            ("bc1", bc1, (1, h)), ("wc2", wc2, (h, 1)), ("bc2", bc2, (1, 1))):
        _check(name, t, shape, dev)
    totf = torch.empty((g, n, 3), dtype=torch.float32, device=dev)
    totm = torch.empty((g, n, h), dtype=torch.float32, device=dev)
    if g == 0:
        return totf, totm
    fn = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (x, hi, hj, efea, mask, wg, we, b1,
                                          w2, b2, wc1, bc1, wc2, bc2,
                                          totf, totm)),
                 g, n, h, e, int(bool(clip_edges)), stream)
    if err != 0:
        raise RuntimeError(f"egnn_pairwise_fwd launch failed: cudaError {err}")
    pairwise_message.launches += 1
    return totf, totm


pairwise_message.launches = 0
