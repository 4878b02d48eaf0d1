"""N-body physics simulators in plain PyTorch (counterpart of
nonode_tpu/sim/simulators.py).

The JAX simulators are XLA programs (``lax.scan`` over time, ``vmap`` over
trajectories), not Pallas kernels; here the time loop is a Python loop and
the batch is a leading dimension: every array is ``[..., N, 3]`` with any
leading batch shape, on whatever device its tensors are.

A trajectory is two steps. ``init_state(generator, batch)`` draws the
initial state on the CPU from an explicit ``torch.Generator``, so a run on
the card and a run on the CPU from one seed start from the same bits (a
seeded run draws other states than JAX's ``_init_state(key)``).
``integrate(state, T, sample_freq)`` integrates from a given state: the
simulators have no weights, and this is how a state from JAX crosses into
the port. ``sample_trajectory`` does both, then adds the observation noise.

Sampling cadences (exactly as the JAX package):
- Charged and springs: one pre-loop velocity kick; then per saved frame
  ``sample_freq - 1`` drift+kick micro-steps, a drift, the record (loc after
  the drift, vel before the kick) and a kick: ``T/sample_freq - 1`` frames;
  the initial state is not saved.
- Gravity: kick-drift-kick leapfrog; the state (pos, vel, force = acc *
  mass) is recorded before each block of ``sample_freq`` steps:
  ``T/sample_freq`` frames, the initial state first.
"""

from __future__ import annotations

import dataclasses

import torch

from ..runtime import resolve_device


def _pairwise(loc):
    """loc [..., N, 3] -> diff[..., i, j] = x_i - x_j, r2[..., i, j]."""
    diff = loc[..., :, None, :] - loc[..., None, :, :]
    r2 = (diff * diff).sum(-1)
    return diff, r2


def _off_diagonal(n, device):
    return 1.0 - torch.eye(n, device=device)


def _obs_noise(generator, noise_var, *arrays):
    """Observation noise on the saved trajectories, ``a += randn *
    noise_var``, drawn on the CPU from ``generator`` after the initial state.
    Nothing is drawn when noise_var is 0."""
    if not noise_var:
        return arrays
    return tuple(a + noise_var * torch.randn(a.shape, generator=generator)
                 .to(a.device) for a in arrays)


def _clamp_walls(loc, vel, box_size):
    """Elastic wall reflection of the initial state, applied once."""
    over = loc > box_size
    loc = torch.where(over, 2 * box_size - loc, loc)
    vel = torch.where(over, -vel.abs(), vel)
    under = loc < -box_size
    loc = torch.where(under, -2 * box_size - loc, loc)
    vel = torch.where(under, vel.abs(), vel)
    return loc, vel


def _unit_velocities(shape, generator, norm):
    vel = torch.randn((*shape, 3), generator=generator)
    return vel * norm / torch.linalg.vector_norm(vel, dim=-1, keepdim=True)


def _check_cadence(T, sample_freq):
    if sample_freq < 1 or T % sample_freq:
        raise ValueError(f"T={T} must be a multiple of sample_freq="
                         f"{sample_freq}")


def _drift_kick_trajectory(force, dt, loc, vel, T, sample_freq):
    """The charged/springs cadence: (locs, vels) [..., T/freq - 1, N, 3]."""
    _check_cadence(T, sample_freq)
    vel = vel + dt * force(loc)                          # pre-loop kick
    locs, vels = [], []
    for _ in range(T // sample_freq - 1):
        for _ in range(sample_freq - 1):
            loc = loc + dt * vel
            vel = vel + dt * force(loc)
        loc = loc + dt * vel
        locs.append(loc)
        vels.append(vel)                     # recorded before this kick
        vel = vel + dt * force(loc)
    return torch.stack(locs, -3), torch.stack(vels, -3)


class _Sampler:
    """``sample_trajectory`` from ``init_state`` and ``integrate``; the first
    ``_TRAJECTORIES`` outputs of ``integrate`` are the saved frames."""

    _TRAJECTORIES = 2

    def sample_trajectory(self, generator, T=10000, sample_freq=10,
                          device=None, batch=None):
        """One trajectory (or ``batch`` of them) from ``generator``'s next
        initial state, on ``device`` (default cuda)."""
        dev = resolve_device(device)
        state = tuple(None if a is None else a.to(dev)
                      for a in self.init_state(generator, batch))
        out = self.integrate(state, T, sample_freq)
        k = self._TRAJECTORIES
        return (*_obs_noise(generator, self.noise_var, *out[:k]), *out[k:])


@dataclasses.dataclass(frozen=True)
class ChargedSim(_Sampler):
    """Coulomb-interacting particles; leapfrog, per-component force clip."""

    n_balls: int = 5
    box_size: float = 5.0
    loc_std: float = 1.0
    vel_norm: float = 0.5
    interaction_strength: float = 1.0
    noise_var: float = 0.0
    dt: float = 0.001

    @property
    def _loc_std(self) -> float:
        # the reference scales loc_std with the particle count
        return self.loc_std * (float(self.n_balls) / 5.0) ** (1.0 / 3.0)

    @property
    def _max_f(self) -> float:
        return 0.1 / self.dt

    def _force(self, loc, edges):
        """F_i = k sum_j q_i q_j (x_i - x_j) / |r_ij|^3, pairs at r2 == 0
        zeroed, clipped per component."""
        diff, r2 = _pairwise(loc)
        inv_r3 = torch.where(r2 > 0, r2 ** -1.5, 0.0)
        fs = self.interaction_strength * edges * inv_r3
        fs = fs * _off_diagonal(self.n_balls, loc.device)
        f = (fs[..., None] * diff).sum(-2)
        return f.clamp(-self._max_f, self._max_f)

    def init_state(self, generator, batch=None):
        """(loc, vel, edges [.., N, N], charges [.., N, 1]) on the CPU."""
        shape = () if batch is None else (batch,)
        n = self.n_balls
        charges = torch.randint(0, 2, (*shape, n, 1),
                                generator=generator).float() * 2.0 - 1.0
        edges = charges @ charges.transpose(-1, -2)
        loc = torch.randn((*shape, n, 3), generator=generator) * self._loc_std
        vel = _unit_velocities((*shape, n), generator, self.vel_norm)
        loc, vel = _clamp_walls(loc, vel, self.box_size)
        return loc, vel, edges, charges

    def integrate(self, state, T=10000, sample_freq=10):
        """(locs [.., T/freq - 1, N, 3], vels, edges, charges)."""
        loc, vel, edges, charges = state
        locs, vels = _drift_kick_trajectory(
            lambda x: self._force(x, edges), self.dt, loc, vel, T, sample_freq)
        return locs, vels, edges, charges

    def energy(self, loc, vel, edges):
        """K + U with U = 0.5 k sum_{i != j} q_i q_j / r_ij (both orders),
        summed over the last two axes."""
        k = 0.5 * (vel ** 2).sum((-2, -1))
        _, r2 = _pairwise(loc)
        dist = torch.sqrt(r2)
        eye = torch.eye(self.n_balls, dtype=torch.bool, device=loc.device)
        inv = torch.where(eye, 0.0, 1.0 / torch.where(dist == 0, torch.inf,
                                                      dist))
        u = 0.5 * self.interaction_strength * (edges * inv).sum((-2, -1))
        return k + u


@dataclasses.dataclass(frozen=True)
class SpringSim(_Sampler):
    """Hookean springs with random spring constants {0, 1}, symmetric."""

    n_balls: int = 5
    box_size: float = 5.0
    loc_std: float = 0.5
    vel_norm: float = 0.5
    interaction_strength: float = 0.1
    noise_var: float = 0.0
    dt: float = 0.001

    @property
    def _max_f(self) -> float:
        return 0.1 / self.dt

    def _force(self, loc, edges):
        diff, _ = _pairwise(loc)
        fs = -self.interaction_strength * edges * _off_diagonal(self.n_balls,
                                                                 loc.device)
        f = (fs[..., None] * diff).sum(-2)
        return f.clamp(-self._max_f, self._max_f)

    def init_state(self, generator, batch=None):
        """(loc, vel, edges [.., N, N], None) on the CPU."""
        shape = () if batch is None else (batch,)
        n = self.n_balls
        tri = torch.randint(0, 2, (*shape, n, n), generator=generator).float()
        edges = torch.tril(tri) + torch.tril(tri, -1).transpose(-1, -2)
        edges = edges * _off_diagonal(n, edges.device)
        loc = torch.randn((*shape, n, 3), generator=generator) * self.loc_std
        vel = _unit_velocities((*shape, n), generator, self.vel_norm)
        loc, vel = _clamp_walls(loc, vel, self.box_size)
        return loc, vel, edges, None

    def integrate(self, state, T=10000, sample_freq=10):
        """(locs [.., T/freq - 1, N, 3], vels, edges, None)."""
        loc, vel, edges, _ = state
        locs, vels = _drift_kick_trajectory(
            lambda x: self._force(x, edges), self.dt, loc, vel, T, sample_freq)
        return locs, vels, edges, None

    def energy(self, loc, vel, edges):
        k = 0.5 * (vel ** 2).sum((-2, -1))
        _, r2 = _pairwise(loc)
        mask = _off_diagonal(self.n_balls, loc.device)
        u = (0.5 * self.interaction_strength * edges * r2 * mask / 2.0).sum(
            (-2, -1))
        return k + u


@dataclasses.dataclass(frozen=True)
class GravitySim(_Sampler):
    """Softened gravity; kick-drift-kick leapfrog."""

    _TRAJECTORIES = 3              # positions, velocities, forces
    n_balls: int = 100
    loc_std: float = 1.0
    vel_norm: float = 0.5          # not read: the initial speeds are randn
    interaction_strength: float = 1.0
    noise_var: float = 0.0
    dt: float = 0.001
    softening: float = 0.1

    def _accel(self, pos, mass):
        """a_i = G sum_j (x_j - x_i) m_j / (r^2 + eps^2)^{3/2}."""
        diff = pos[..., None, :, :] - pos[..., :, None, :]   # x_j - x_i
        r2 = (diff * diff).sum(-1) + self.softening ** 2
        inv_r3 = torch.where(r2 > 0, r2 ** -1.5, 0.0)
        return self.interaction_strength * torch.einsum(
            "...ijd,...ij,...j->...id", diff, inv_r3, mass[..., 0])

    def init_state(self, generator, batch=None):
        """(pos, vel, mass [.., N, 1]) on the CPU, in the centre-of-momentum
        frame; vel_norm is not used."""
        shape = () if batch is None else (batch,)
        n = self.n_balls
        mass = 1.0 + torch.randn((*shape, n, 1), generator=generator) \
            * self.loc_std * 0.1
        pos = torch.randn((*shape, n, 3), generator=generator)
        vel = torch.randn((*shape, n, 3), generator=generator)
        vel = vel - (mass * vel).mean(-2, keepdim=True) \
            / mass.mean((-2, -1), keepdim=True)
        return pos, vel, mass

    def integrate(self, state, T=10000, sample_freq=10):
        """(poss [.., T/freq, N, 3], vels, forces, mass)."""
        _check_cadence(T, sample_freq)
        pos, vel, mass = state
        acc = self._accel(pos, mass)
        poss, vels, forces = [], [], []
        for _ in range(T // sample_freq):
            poss.append(pos)
            vels.append(vel)
            forces.append(acc * mass)
            for _ in range(sample_freq):
                vel = vel + acc * self.dt / 2.0
                pos = pos + vel * self.dt
                acc = self._accel(pos, mass)
                vel = vel + acc * self.dt / 2.0
        return (torch.stack(poss, -3), torch.stack(vels, -3),
                torch.stack(forces, -3), mass)

    def energy(self, pos, vel, mass):
        ke = 0.5 * (mass * vel ** 2).sum((-2, -1))
        diff = pos[..., None, :, :] - pos[..., :, None, :]
        r = torch.sqrt((diff * diff).sum(-1))
        inv_r = torch.where(r > 0, 1.0 / torch.where(r == 0, torch.inf, r),
                            0.0)
        pe = self.interaction_strength * torch.triu(
            -(mass * mass.transpose(-1, -2)) * inv_r, 1).sum((-2, -1))
        return ke + pe


SIM_REGISTRY = {"charged": ChargedSim, "gravity": GravitySim,
                "springs": SpringSim}


def sample_batch(sim, generator, num, T, sample_freq, device=None):
    """``num`` independent trajectories, integrated together as one batch."""
    return sim.sample_trajectory(generator, T, sample_freq, device=device,
                                 batch=num)
