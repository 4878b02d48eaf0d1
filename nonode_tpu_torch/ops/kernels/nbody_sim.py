"""Fused multi-step N-body integration: CUDA kernels
(``csrc/nbody_leapfrog.cu``) that run a whole sampling block of micro-steps
in one launch, with the plain PyTorch version of each beside it.

Counterparts of nonode_tpu/ops/pallas/nbody_sim.py:
- ``charged_leapfrog`` (``charged_leapfrog_block`` over
  ``_charged_block_kernel``): ``steps`` micro-steps of
  ``pos += dt * vel; vel += dt * F(pos)`` with the clipped Coulomb force of
  ``pairwise.charged_force``;
- ``gravity_leapfrog`` (``gravity_leapfrog_block`` over
  ``_gravity_block_kernel``): ``steps`` kick-drift-kick micro-steps
  ``vel += acc * (dt/2); pos += vel * dt; acc = a(pos); vel += acc * (dt/2)``
  with the softened gravity of ``pairwise.gravity_accel``.

On the card one launch is a persistent cooperative grid with one grid-wide
barrier per micro-step (the source says why). Any N >= 1 is taken: beyond
what the card holds resident at once, each warp owns several bodies. The
sums are in a fixed order, so a launch gives the same bits every time.
``steps`` must be at least 1 (``LargeNChargedSim`` never asks for 0). The
wrappers take the plain version for CPU tensors only; for CUDA tensors they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .pairwise import (charged_force_reference, check_bodies, cuda_device,
                       gravity_accel_reference, raise_on_error)

SOURCE = "nbody_leapfrog.cu"


def charged_leapfrog_reference(pos, vel, charges, steps, dt=0.001, k=1.0,
                               max_f=100.0):
    """Plain PyTorch version of ``charged_leapfrog``: (pos, vel)."""
    for _ in range(steps):
        pos = pos + dt * vel
        vel = vel + dt * charged_force_reference(pos, charges, k, max_f)
    return pos, vel


def gravity_leapfrog_reference(pos, vel, acc, mass, steps, dt=0.001, g=1.0,
                               softening=0.1):
    """Plain PyTorch version of ``gravity_leapfrog``: (pos, vel, acc)."""
    for _ in range(steps):
        vel = vel + acc * (dt / 2.0)
        pos = pos + vel * dt
        acc = gravity_accel_reference(pos, mass, g, softening)
        vel = vel + acc * (dt / 2.0)
    return pos, vel, acc


def _check_steps(steps):
    if int(steps) != steps or steps < 1:
        raise ValueError(f"steps={steps}: a block runs at least one "
                         f"micro-step")
    return int(steps)


def _bind():
    lib = load(SOURCE)
    lib.nbody_charged_leapfrog.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
        + [ctypes.c_void_p])
    lib.nbody_gravity_leapfrog.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])
    lib.nbody_leapfrog_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    for fn in (lib.nbody_charged_leapfrog, lib.nbody_gravity_leapfrog,
               lib.nbody_leapfrog_grid):
        fn.restype = ctypes.c_int
    return lib


def launch_grid(n, gravity=False):
    """Blocks of the cooperative grid a block kernel launches for n bodies on
    the current CUDA device."""
    grid = _bind().nbody_leapfrog_grid(int(n), int(bool(gravity)))
    if grid < 0:
        raise RuntimeError(f"occupancy query failed: cudaError {-grid}")
    return grid


def charged_leapfrog(pos, vel, charges, steps, dt=0.001, k=1.0, max_f=100.0):
    """Advance (pos, vel) by ``steps`` drift-force-kick micro-steps.
    pos/vel [N, 3]; charges [N] or [N, 1]."""
    steps = _check_steps(steps)
    if pos.device.type == "cpu":
        return charged_leapfrog_reference(pos, vel, charges, steps, dt, k,
                                          max_f)
    dev = cuda_device(pos)
    n, q = check_bodies(pos, charges, vel=vel)
    pos_out, vel_out = (torch.empty_like(pos) for _ in range(2))
    buf = torch.empty((2, n, 3), dtype=torch.float32, device=dev)
    lib = _bind()
    with torch.cuda.device(dev):
        err = lib.nbody_charged_leapfrog(
            *(t.data_ptr() for t in (pos, vel, q, pos_out, vel_out, buf)),
            n, steps, dt, k, max_f, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "nbody_charged_leapfrog", err)
    charged_leapfrog.launches += 1
    return pos_out, vel_out


def gravity_leapfrog(pos, vel, acc, mass, steps, dt=0.001, g=1.0,
                     softening=0.1):
    """Advance (pos, vel, acc) by ``steps`` kick-drift-kick micro-steps.
    pos/vel/acc [N, 3]; mass [N] or [N, 1]."""
    steps = _check_steps(steps)
    if pos.device.type == "cpu":
        return gravity_leapfrog_reference(pos, vel, acc, mass, steps, dt, g,
                                          softening)
    dev = cuda_device(pos)
    n, m = check_bodies(pos, mass, vel=vel, acc=acc)
    pos_out, vel_out, acc_out = (torch.empty_like(pos) for _ in range(3))
    buf = torch.empty((2, n, 3), dtype=torch.float32, device=dev)
    lib = _bind()
    with torch.cuda.device(dev):
        err = lib.nbody_gravity_leapfrog(
            *(t.data_ptr() for t in (pos, vel, acc, m, pos_out, vel_out,
                                     acc_out, buf)),
            n, steps, dt, dt / 2.0, g, softening * softening,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "nbody_gravity_leapfrog", err)
    gravity_leapfrog.launches += 1
    return pos_out, vel_out, acc_out


charged_leapfrog.launches = 0
gravity_leapfrog.launches = 0
