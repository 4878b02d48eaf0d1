"""Dataset writer (counterpart of nonode_tpu/sim/generate.py).

    python -m nonode_tpu_torch.sim.generate --simulation gravity \\
        --num-train 512 --num-valid 256 --num-test 256 --length 3000 \\
        --length_test 3000 --suffix small --outdir data_gravity

Writes the reference's file layout
(``{loc,vel,edges,charges}_{train,valid,test}{suffix}.npy``) with the quirks
the loaders rely on:
- charged/springs: loc/vel as [S, T_save, 3, N];
- gravity: loc/vel as [S, T_save, N, 3]; the ``edges`` file holds the
  per-frame forces and ``charges`` the masses;
- springs: charges are ones, and ``--initial_vel`` is ignored (the
  reference builds SpringSim without vel_norm).

The dense simulators run on ``--device`` (default cuda) in batches of
``--chunk`` trajectories. Initial states come from one CPU
``torch.Generator`` seeded with ``--seed``, so the files from one seed are
the same on the card and on the CPU up to fp32 rounding, and differ from the
JAX writer's (another generator).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..runtime import resolve_device
from .simulators import SIM_REGISTRY, sample_batch


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--simulation", type=str, default="charged",
                        choices=["springs", "charged", "gravity"])
    parser.add_argument("--num-train", type=int, default=10000)
    parser.add_argument("--num-valid", type=int, default=2000)
    parser.add_argument("--num-test", type=int, default=2000)
    parser.add_argument("--length", type=int, default=20000)
    parser.add_argument("--length_test", type=int, default=52000)
    parser.add_argument("--sample-freq", type=int, default=100)
    parser.add_argument("--n_balls", type=int, default=5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--initial_vel", type=int, default=1)
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--outdir", type=Path, default="data")
    parser.add_argument("--chunk", type=int, default=500,
                        help="trajectories integrated together in one batch")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def generate_split(sim, generator, num_sims, length, sample_freq, chunk, kind,
                   device):
    """(loc, vel, edges, charges) of ``num_sims`` trajectories as numpy, in
    the file layouts."""
    locs, vels, edges, charges = [], [], [], []
    done = 0
    while done < num_sims:
        n = min(chunk, num_sims - done)
        loc, vel, e, q = sample_batch(sim, generator, n, length, sample_freq,
                                      device=device)
        loc, vel = loc.cpu().numpy(), vel.cpu().numpy()
        if kind in ("charged", "springs"):
            loc = loc.transpose(0, 1, 3, 2)                  # [S, T, 3, N]
            vel = vel.transpose(0, 1, 3, 2)
        locs.append(loc)
        vels.append(vel)
        edges.append(e.cpu().numpy())
        charges.append(np.ones((n, sim.n_balls, 1), np.float32)
                       if q is None else q.cpu().numpy())
        done += n
    return (np.concatenate(locs), np.concatenate(vels),
            np.concatenate(edges), np.concatenate(charges))


def main(args):
    device = resolve_device(args.device)
    initial_vel_norm = 0.5 if args.initial_vel else 1e-16
    sim_cls = SIM_REGISTRY[args.simulation]
    if args.simulation == "springs":
        sim = sim_cls(noise_var=0.0, n_balls=args.n_balls)
    else:
        sim = sim_cls(noise_var=0.0, n_balls=args.n_balls,
                      vel_norm=initial_vel_norm)
    suffix = {"springs": "_springs", "charged": "_charged",
              "gravity": "_gravity"}[args.simulation]
    suffix += str(args.n_balls) + "_initvel%d" % args.initial_vel + args.suffix
    print(suffix)

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator().manual_seed(args.seed)
    splits = [("train", args.num_train, args.length),
              ("valid", args.num_valid, args.length),
              ("test", args.num_test, args.length_test)]
    for name, num, length in splits:
        t0 = time.perf_counter()
        loc, vel, edges, charges = generate_split(
            sim, generator, num, length, args.sample_freq, args.chunk,
            args.simulation, device)
        print(f"{name}: {num} sims x {length} steps in "
              f"{time.perf_counter() - t0:.2f}s -> loc {loc.shape}")
        np.save(outdir / f"loc_{name}{suffix}.npy", loc)
        np.save(outdir / f"vel_{name}{suffix}.npy", vel)
        np.save(outdir / f"edges_{name}{suffix}.npy", edges)
        np.save(outdir / f"charges_{name}{suffix}.npy", charges)


if __name__ == "__main__":
    main(get_args())
