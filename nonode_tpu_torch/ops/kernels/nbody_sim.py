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

``charged_leapfrog`` can also record the last micro-step between its drift
and its kick (``record=``): the position after the drift and the velocity
before the kick, the state that ``LargeNChargedSim`` saves at each sample
point, so that a whole frame is one launch.

On the card one launch is a persistent cooperative grid, one block per SM,
that keeps the bodies' state in shared memory for all its micro-steps and
exchanges only the new positions, once a micro-step, as tagged 64-bit words
that the other blocks poll (no grid barrier; the source says why and how).
Beyond what the grid covers at once, each block owns its bodies in several
passes; the owners' state must fit one block's shared memory (on an H100
up to about 790,000 bodies for gravity, 1.18 million charged), and a launch
for more raises. The sums are in a fixed order that depends on N alone, so
a launch gives the same bits every time, and the same as one-step launches
chained. ``steps`` must be at least 1 (``LargeNChargedSim`` never asks for
0). The wrappers take the plain version for CPU tensors only; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .pairwise import (charged_force_reference, check_bodies, cuda_device,
                       gravity_accel_reference, raise_on_error)

SOURCE = "nbody_leapfrog.cu"


def charged_leapfrog_reference(pos, vel, charges, steps, dt=0.001, k=1.0,
                               max_f=100.0, record=None):
    """Plain PyTorch version of ``charged_leapfrog``: (pos, vel), and the
    last micro-step's drifted position and unkicked velocity copied into
    ``record`` when it is given."""
    for s in range(steps):
        pos = pos + dt * vel
        if record is not None and s == steps - 1:
            record[0].copy_(pos)
            record[1].copy_(vel)
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
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
        + [ctypes.c_void_p])
    lib.nbody_gravity_leapfrog.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])
    lib.nbody_leapfrog_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.nbody_leapfrog_probe.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float]
        + [ctypes.c_int, ctypes.c_void_p])
    for fn in (lib.nbody_charged_leapfrog, lib.nbody_gravity_leapfrog,
               lib.nbody_leapfrog_shape, lib.nbody_leapfrog_probe):
        fn.restype = ctypes.c_int
    return lib


SHAPE_KEYS = ("blocks", "threads", "receivers_per_pass", "warps_per_receiver",
              "passes", "smem_bytes")


def launch_shape(n, gravity=False):
    """The cooperative launch a block kernel makes for n bodies on the
    current CUDA device: blocks of threads, each owning
    ``receivers_per_pass`` receivers summed by ``warps_per_receiver`` warps
    each, in ``passes`` passes, and its dynamic shared memory."""
    lib = _bind()
    out = (ctypes.c_int * len(SHAPE_KEYS))()
    raise_on_error(lib, "nbody_leapfrog_shape",
                   lib.nbody_leapfrog_shape(int(n), int(bool(gravity)), out))
    return dict(zip(SHAPE_KEYS, out))


def _words(n, dev):
    """The kernels' scratch: two buffers of tagged positions, [3, n] 64-bit
    words each."""
    return torch.empty((2, 3, n), dtype=torch.int64, device=dev)


def charged_leapfrog(pos, vel, charges, steps, dt=0.001, k=1.0, max_f=100.0,
                     record=None):
    """Advance (pos, vel) by ``steps`` drift-force-kick micro-steps.
    pos/vel [N, 3]; charges [N] or [N, 1]. ``record``, a pair of contiguous
    fp32 [N, 3] tensors on pos's device (rows of the caller's trajectory),
    receives the last micro-step's position after its drift and velocity
    before its kick."""
    steps = _check_steps(steps)
    if record is not None:
        rec_pos, rec_vel = record
        check_bodies(pos, charges, rec_pos=rec_pos, rec_vel=rec_vel)
    if pos.device.type == "cpu":
        return charged_leapfrog_reference(pos, vel, charges, steps, dt, k,
                                          max_f, record)
    dev = cuda_device(pos)
    n, q = check_bodies(pos, charges, vel=vel)
    pos_out, vel_out = (torch.empty_like(pos) for _ in range(2))
    rec = (None, None) if record is None else (rec_pos.data_ptr(),
                                               rec_vel.data_ptr())
    buf = _words(n, dev)
    lib = _bind()
    with torch.cuda.device(dev):
        err = lib.nbody_charged_leapfrog(
            *(t.data_ptr() for t in (pos, vel, q, pos_out, vel_out)), *rec,
            buf.data_ptr(), n, steps, dt, k, max_f,
            torch.cuda.current_stream(dev).cuda_stream)
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
    buf = _words(n, dev)
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


# The probe's schemes (``nbody_leapfrog_probe``): this design's micro-step
# without the pair sums, then without waiting for the tags too, then without
# reading the words at all; and the parts of the earlier grid-barrier
# scheme (a barrier and a restage of every position per micro-step).
PROBE_SCHEMES = {1: "exchange, staging and updates",
                 2: "the same, each word read once without waiting",
                 3: "the same, no word read",
                 6: "grid-barrier scheme: drift, barrier and restage",
                 4: "grid-barrier scheme: drift and barrier",
                 5: "grid-barrier scheme: drift and restage"}


def leapfrog_probe(pos, vel, charges, steps, dt=0.001, scheme=1):
    """The charged block kernel's micro-steps with the pair sums left out
    (``csrc/nbody_leapfrog.cu``, ``nbody_leapfrog_probe``): what a micro-step
    costs besides the force pass, split as PROBE_SCHEMES says, in this design
    or in the earlier grid-barrier design. CUDA tensors only; its outputs
    are not the simulation's. No path calls it;
    ``scripts/profile_torch_stretch.py --probe`` and chip_smoke.py time
    it."""
    steps = _check_steps(steps)
    if scheme not in PROBE_SCHEMES:
        raise ValueError(f"scheme={scheme}: one of {sorted(PROBE_SCHEMES)}")
    dev = cuda_device(pos)
    n, q = check_bodies(pos, charges, vel=vel)
    pos_out, vel_out = (torch.empty_like(pos) for _ in range(2))
    buf = _words(n, dev)
    lib = _bind()
    with torch.cuda.device(dev):
        err = lib.nbody_leapfrog_probe(
            *(t.data_ptr() for t in (pos, vel, q, pos_out, vel_out, buf)),
            n, steps, dt, scheme, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, "nbody_leapfrog_probe", err)
    return pos_out, vel_out


charged_leapfrog.launches = 0
gravity_leapfrog.launches = 0
