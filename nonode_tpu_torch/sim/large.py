"""Large-N simulators on the N-body kernels (counterpart of
nonode_tpu/sim/large.py).

Same physics, state and cadence as ``simulators.py``, for one large system
(the 1000-body stretch run) rather than batches of small ones: each sampling
block of micro-steps is one launch of a fused integration kernel
(``ops/kernels/nbody_sim.py``), which for the charged system also records
the frame, and the single force evaluation before the loop goes to a
pairwise kernel (``ops/kernels/pairwise.py``). On CUDA tensors every call
launches a kernel or raises; on CPU tensors the kernels' plain versions run.

One deliberate difference: ``LargeNGravitySim`` takes its first
acceleration from the gravity kernel (``gravity_accel``), the JAX class
from the dense ``GravitySim._accel``; the formula is the same.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.kernels.nbody_sim import charged_leapfrog, gravity_leapfrog
from ..ops.kernels.pairwise import charged_force, gravity_accel
from .simulators import ChargedSim, GravitySim, _check_cadence


def _one_system(pos):
    if pos.dim() != 2:
        raise ValueError(f"state of shape {tuple(pos.shape)}: the large-N "
                         f"simulators integrate one [N, 3] system at a time")


@dataclasses.dataclass(frozen=True)
class LargeNGravitySim(GravitySim):
    """GravitySim with fused kick-drift-kick blocks."""

    def integrate(self, state, T=10000, sample_freq=10):
        """(poss [T/freq, N, 3], vels, forces, mass)."""
        _check_cadence(T, sample_freq)
        pos, vel, mass = state
        _one_system(pos)
        kw = dict(g=self.interaction_strength, softening=self.softening)
        acc = gravity_accel(pos, mass, **kw)
        poss, vels, forces = [], [], []
        for _ in range(T // sample_freq):
            poss.append(pos)
            vels.append(vel)
            forces.append(acc * mass)
            pos, vel, acc = gravity_leapfrog(pos, vel, acc, mass,
                                             steps=sample_freq, dt=self.dt,
                                             **kw)
        return torch.stack(poss), torch.stack(vels), torch.stack(forces), mass


@dataclasses.dataclass(frozen=True)
class LargeNChargedSim(ChargedSim):
    """ChargedSim with fused drift-force-kick blocks.

    The state saved at each sample point is the position after the drift
    and the velocity before that step's kick: each frame is one block of
    freq micro-steps that records its last one between its drift and its
    kick, straight into the frame's rows of the trajectory. (The JAX class
    runs freq - 1 fused steps and the last drift, force and kick outside
    the kernel; the arithmetic is the same.)
    """

    def integrate(self, state, T=10000, sample_freq=10):
        """(locs [T/freq - 1, N, 3], vels, edges, charges)."""
        _check_cadence(T, sample_freq)
        loc, vel, edges, charges = state
        _one_system(loc)
        kw = dict(k=self.interaction_strength, max_f=self._max_f)
        # the kick before the loop, then one recorded block a frame
        vel = vel + self.dt * charged_force(loc, charges, **kw)
        frames = T // sample_freq - 1
        locs = loc.new_empty((frames, *loc.shape))
        vels = vel.new_empty((frames, *vel.shape))
        for f in range(frames):
            loc, vel = charged_leapfrog(loc, vel, charges, steps=sample_freq,
                                        dt=self.dt, record=(locs[f], vels[f]),
                                        **kw)
        return locs, vels, edges, charges
