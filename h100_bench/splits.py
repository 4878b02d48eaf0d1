"""The charged N-body splits of a configuration, simulated from the seed on
the device (the physics of the NO-NODE-comparison repository's
``generate_dataset.py`` charged simulation, in float32): particles of
charge +-1 under the clipped Coulomb force, integrated by leapfrog with
step ``dt`` and saved every ``sample_freq`` steps.

The cadence is the reference generator's: one velocity kick before the
loop; then for each saved frame ``sample_freq - 1`` drift-and-kick steps, a
drift, the record (the position after the drift, the velocity before the
kick) and a kick; the initial state is not saved. A split of ``length``
steps has ``length // sample_freq - 1`` frames.

All splits are integrated together while they run, the test split alone
after the others end; on the card a saved frame's ``sample_freq`` steps
are one CUDA graph, so that the host launches once a frame."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

SPLITS = ("train", "valid", "test")


def initial_state(cfg, count, generator, device):
    """(loc, vel, charges) [S, N, 3], [S, N, 3], [S, N, 1]: positions
    N(0, loc_std^2 (N/5)^(2/3)) reflected once into the box, velocities of
    norm ``vel_norm`` in random directions, charges +-1."""
    n = cfg["n_balls"]
    charges = torch.randint(0, 2, (count, n, 1), generator=generator,
                            device=device).float() * 2.0 - 1.0
    std = cfg["loc_std"] * (n / 5.0) ** (1.0 / 3.0)
    loc = torch.randn((count, n, 3), generator=generator,
                      device=device) * std
    vel = torch.randn((count, n, 3), generator=generator, device=device)
    vel = vel * cfg["vel_norm"] / vel.norm(dim=-1, keepdim=True)
    box = cfg["box_size"]
    over, under = loc > box, loc < -box
    loc = torch.where(over, 2 * box - loc, loc)
    vel = torch.where(over, -vel.abs(), vel)
    loc = torch.where(under, -2 * box - loc, loc)
    vel = torch.where(under, vel.abs(), vel)
    return loc, vel, charges


class _Integrator:
    """Leapfrog of the charged system in place on (loc, vel)."""

    def __init__(self, cfg, loc, vel, charges):
        n = loc.shape[1]
        self.cfg = cfg
        self.loc, self.vel, self.charges = loc, vel, charges
        self.dt = cfg["dt"]
        self.clip = 0.1 / cfg["dt"]
        self.qq = (charges * charges.transpose(1, 2)) * cfg[
            "interaction_strength"]
        self.diag = torch.eye(n, dtype=torch.bool, device=loc.device)
        self.record = (torch.empty_like(loc), torch.empty_like(vel))

    def kick(self):
        """v += dt * F(x): F_i = sum_j q_i q_j (x_i - x_j) / r_ij^3 over
        j != i, clipped per component to +-0.1 / dt."""
        diff = self.loc[:, :, None, :] - self.loc[:, None, :, :]
        r2 = (diff * diff).sum(-1)
        inv = r2.masked_fill(self.diag, 1.0).pow(-1.5).masked_fill(
            self.diag, 0.0)
        force = torch.einsum("sij,sijd->sid", self.qq * inv, diff)
        self.vel.add_(force.clamp(-self.clip, self.clip), alpha=self.dt)

    def drift(self):
        self.loc.add_(self.vel, alpha=self.dt)

    def frame(self, steps):
        """``steps`` steps whose last drift is recorded before its kick."""
        for _ in range(steps - 1):
            self.drift()
            self.kick()
        self.drift()
        self.record[0].copy_(self.loc)
        self.record[1].copy_(self.vel)
        self.kick()

    def frames(self):
        """A callable that advances one saved frame: on the card the
        frame's steps as one CUDA graph (capturing runs nothing; a copy of
        the state warms the kernels up first)."""
        steps = self.cfg["sample_freq"]
        if self.loc.device.type != "cuda":
            return lambda: self.frame(steps)
        scratch = _Integrator(self.cfg, self.loc.clone(), self.vel.clone(),
                              self.charges)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            scratch.frame(2)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.frame(steps)
        return graph.replay


def simulate(cfg, generator, device):
    """{split: (loc [S, F, N, 3], vel [S, F, N, 3], charges [S, N, 1])} on
    the device, the splits' sizes and step counts from ``cfg``."""
    counts = [cfg[f"num_{s}"] for s in SPLITS]
    frames = [cfg["length_test" if s == "test" else "length"]
              // cfg["sample_freq"] - 1 for s in SPLITS]
    loc, vel, charges = initial_state(cfg, sum(counts), generator, device)
    # the longest splits last, so that the systems still running are a
    # suffix once the shorter splits are done
    order = sorted(range(len(SPLITS)), key=lambda i: frames[i])
    starts = np.cumsum([0] + counts)
    perm = torch.cat([torch.arange(int(starts[i]), int(starts[i + 1]),
                                   device=device) for i in order])
    loc, vel, charges = loc[perm], vel[perm], charges[perm]
    out_loc = torch.empty((sum(counts), max(frames), *loc.shape[1:]),
                          device=device)
    out_vel = torch.empty_like(out_loc)
    sizes = [counts[i] for i in order]
    done = 0
    for stage, i in enumerate(order):
        live = sum(sizes[stage:])
        if frames[i] <= done:
            continue
        sim = _Integrator(cfg, loc[-live:].clone(), vel[-live:].clone(),
                          charges[-live:])
        if done == 0:
            sim.kick()                  # the kick before the loop
        step = sim.frames()
        for f in range(done, frames[i]):
            step()
            out_loc[-live:, f] = sim.record[0]
            out_vel[-live:, f] = sim.record[1]
        loc[-live:], vel[-live:] = sim.loc, sim.vel
        done = frames[i]
    result, off = {}, 0
    for i, size in zip(order, sizes):
        result[SPLITS[i]] = (out_loc[off:off + size, :frames[i]],
                             out_vel[off:off + size, :frames[i]],
                             charges[off:off + size])
        off += size
    return result


def write(splits, cfg, directory):
    """Save the splits as the data loader of the program reads them:
    ``{loc,vel,charges}_{split}_charged{N}_initvel1small.npy``, positions
    and velocities as [S, F, 3, N] (the reference generator's layout).
    Returns the host copies {split: (loc, vel, charges)} as [S, F, N, 3]
    float32 numpy arrays."""
    directory = Path(directory)
    suffix = f"_{cfg['dataset']}{cfg['n_balls']}_initvel1small"
    host = {}
    for name, (loc, vel, charges) in splits.items():
        loc, vel = loc.cpu().numpy(), vel.cpu().numpy()
        charges = charges.cpu().numpy()
        for key, a in (("loc", loc), ("vel", vel)):
            np.save(directory / f"{key}_{name}{suffix}.npy",
                    a.transpose(0, 1, 3, 2))
        np.save(directory / f"charges_{name}{suffix}.npy", charges)
        host[name] = (loc, vel, charges)
    return host
