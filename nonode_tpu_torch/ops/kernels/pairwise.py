"""Pairwise N-body forces for large particle counts: CUDA kernels
(``csrc/nbody_pairwise.cu``) with the plain PyTorch version of each beside
it.

Counterparts of nonode_tpu/ops/pallas/pairwise.py:
- ``charged_force`` (``_charged_kernel``): Coulomb forces
  ``F_i = k sum_{j != i} q_i q_j (x_i - x_j) / r^3``, only the self pair
  masked, each component clipped at +-max_f;
- ``gravity_accel`` (``_gravity_kernel``): softened gravity
  ``a_i = G sum_j m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}``, the self pair
  included (its difference is 0).

Both keep the TPU kernels' semantics, which differ from the dense
simulators' in one place: a distinct pair at distance 0 is not masked
(``ChargedSim._force`` zeroes every pair with r2 == 0). The TPU wrappers'
``block_i`` and ``interpret`` have no counterpart: the kernels choose their
own launch, and need no padding. The wrappers take the plain version for CPU
tensors only; for CUDA tensors they launch the kernel or raise.

On the card both kernels sum in the order of the leapfrog block kernels
(``csrc/nbody_pair.cuh``), so a force from here has the bits of the force a
micro-step of ``nbody_sim.charged_leapfrog`` (or ``gravity_leapfrog``)
computes from the same positions.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

SOURCE = "nbody_pairwise.cu"


def charged_force_reference(pos, charges, k=1.0, max_f=100.0):
    """Plain PyTorch version of ``charged_force`` on the dense [N, N] pairs."""
    n = pos.shape[0]
    q = charges.reshape(-1)
    diff = pos[:, None, :] - pos[None, :, :]                  # x_i - x_j
    r2 = (diff * diff).sum(-1)
    valid = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    inv_r = torch.rsqrt(torch.where(valid, r2, 1.0))
    w = torch.where(valid, k * q[:, None] * q[None, :] * inv_r * inv_r * inv_r,
                    0.0)
    return (diff * w[..., None]).sum(1).clamp(-max_f, max_f)


def gravity_accel_reference(pos, mass, g=1.0, softening=0.1):
    """Plain PyTorch version of ``gravity_accel`` on the dense [N, N] pairs."""
    diff = pos[None, :, :] - pos[:, None, :]                  # x_j - x_i
    r2 = (diff * diff).sum(-1) + softening * softening
    inv_r = torch.rsqrt(r2)
    w = mass.reshape(1, -1) * inv_r * inv_r * inv_r
    return g * (diff * w[..., None]).sum(1)


def check_bodies(pos, weights, **state):
    """N of a launch after checking its tensors: pos and every named state
    tensor [N, 3], weights N values, all fp32 and contiguous on pos's device.
    Returns (n, weights flattened)."""
    if pos.dim() != 2 or pos.shape[1] != 3 or pos.shape[0] < 1:
        raise ValueError(f"pos has shape {tuple(pos.shape)}; the kernel takes "
                         f"[N, 3] with N >= 1")
    n = pos.shape[0]
    w = weights.reshape(-1)
    if w.numel() != n:
        raise ValueError(f"{w.numel()} charges or masses for {n} bodies")
    for name, t in (("pos", pos), ("weights", w), *state.items()):
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, expected {pos.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if name != "weights" and tuple(t.shape) != (n, 3):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({n}, 3)")
    return n, w


def raise_on_error(lib, name, err):
    """Raise with the CUDA error's name when a launch returned one."""
    if err != 0:
        lib.nbody_error_name.argtypes = [ctypes.c_int]
        lib.nbody_error_name.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({lib.nbody_error_name(err).decode()})")


def cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}; the kernels take "
                         f"cuda tensors, the plain versions cpu tensors")
    return t.device


def _bind():
    lib = load(SOURCE)
    for fn in (lib.nbody_charged_force, lib.nbody_gravity_accel):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.nbody_pairwise_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.nbody_pairwise_shape.restype = ctypes.c_int
    return lib


SHAPE_KEYS = ("blocks", "threads", "receivers_per_block",
              "warps_per_receiver", "senders_per_tile", "tiles", "smem_bytes")


def launch_shape(n, gravity=False):
    """The launch a force kernel makes for n bodies on the current CUDA
    device: blocks of threads, each summing ``receivers_per_block``
    receivers at a time with ``warps_per_receiver`` warps each; the senders
    staged in ``tiles`` tiles of up to ``senders_per_tile`` (one tile, staged
    in one wave, while they fit a block's shared memory); its dynamic shared
    memory."""
    lib = _bind()
    out = (ctypes.c_int * len(SHAPE_KEYS))()
    raise_on_error(lib, "nbody_pairwise_shape",
                   lib.nbody_pairwise_shape(int(n), int(bool(gravity)), out))
    return dict(zip(SHAPE_KEYS, out))


def _launch(name, pos, weights, *constants):
    dev = cuda_device(pos)
    n, w = check_bodies(pos, weights)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lib = _bind()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(pos.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 n, *constants,
                                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, name, err)
    return out


def charged_force(pos, charges, k=1.0, max_f=100.0):
    """Clipped Coulomb forces. pos [N, 3]; charges [N] or [N, 1] -> [N, 3]."""
    if pos.device.type == "cpu":
        return charged_force_reference(pos, charges, k, max_f)
    out = _launch("nbody_charged_force", pos, charges, float(k), float(max_f))
    charged_force.launches += 1
    return out


def gravity_accel(pos, mass, g=1.0, softening=0.1):
    """Softened gravity. pos [N, 3]; mass [N] or [N, 1] -> acc [N, 3]."""
    if pos.device.type == "cpu":
        return gravity_accel_reference(pos, mass, g, softening)
    out = _launch("nbody_gravity_accel", pos, mass, float(g),
                  float(softening * softening))
    gravity_accel.launches += 1
    return out


charged_force.launches = 0
gravity_accel.launches = 0
