"""Large-N simulators on the N-body kernels (counterpart of
nonode_tpu/sim/large.py).

Same physics, state and cadence as ``simulators.py``, for one large system
(the 1000-body stretch run) rather than batches of small ones: each sampling
block of micro-steps is one launch of a fused integration kernel
(``ops/kernels/nbody_sim.py``), and the single force evaluations go to the
pairwise kernels (``ops/kernels/pairwise.py``). On CUDA tensors every call
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
    and the velocity before that step's kick, so each block runs freq - 1
    fused steps and the last drift, record and kick happen here.
    """

    def _force_large(self, loc, charges):
        return charged_force(loc, charges, k=self.interaction_strength,
                             max_f=self._max_f)

    def integrate(self, state, T=10000, sample_freq=10):
        """(locs [T/freq - 1, N, 3], vels, edges, charges)."""
        _check_cadence(T, sample_freq)
        loc, vel, edges, charges = state
        _one_system(loc)
        vel = vel + self.dt * self._force_large(loc, charges)  # pre-loop kick
        locs, vels = [], []
        for _ in range(T // sample_freq - 1):
            if sample_freq > 1:
                loc, vel = charged_leapfrog(
                    loc, vel, charges, steps=sample_freq - 1, dt=self.dt,
                    k=self.interaction_strength, max_f=self._max_f)
            loc = loc + self.dt * vel
            locs.append(loc)
            vels.append(vel)
            vel = vel + self.dt * self._force_large(loc, charges)
        return torch.stack(locs), torch.stack(vels), edges, charges
