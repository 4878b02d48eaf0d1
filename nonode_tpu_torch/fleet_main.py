"""Seed-fleet driver: train every seed of a sweep group at once
(counterpart of nonode_tpu/fleet_main.py).

``python -m nonode_tpu_torch.fleet_main --model {egno,segno} --dataset
charged --seeds 1,2,3,4,5 [--device cpu]``

The K seeds train as one program (parallel/fleet.py): each step runs the
experiment's loss vmapped over the seeds' stacked parameters, so every op,
#1 and #2 included, is launched once for all K. Early stopping runs per
seed on the host with the decisions K sequential EarlyStopping instances
would make; stopped seeds are compacted out of the fleet (parameters and
Adam's state). Then each seed's best weights are saved as its checkpoint
and tested with the single-model experiment's rollout, and written as that
seed's ``_results.npz`` artifact: what K sequential runs of
``nonode_tpu_torch.main`` write, seed by seed.

Covers EGNO with one input, several inputs and varDT (each seed draws its
own per-epoch input offsets from its own rng stream), and SEGNO with one
input. SEGNO multi-input and varDT cells run through the sequential driver,
as in the JAX package. Every flag of nonode_tpu/fleet_main.py, plus
``--device``; ``--config`` defaults to the built-in model_confs.yaml values.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .analysis.registry import artifact_stem
from .data.nbody import NBodyDataset
from .main import build_experiment, str2bool
from .parallel.fleet import FleetEarlyStopping, SeedFleet
from .runtime import resolve_device, seed_everything
from .train.checkpoint import save_params
from .train.loop import make_perm


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Seed-fleet trainer")
    parser.add_argument("--model", type=str, default="egno",
                        choices=["egno", "segno"])
    parser.add_argument("--exp_name", type=str, default="0exp_fleet")
    parser.add_argument("--config", type=str, default=None,
                        help="model_confs.yaml-schema file; default: the "
                             "built-in model_confs.yaml values")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--data_dir", type=Path, default="data")
    parser.add_argument("--dataset", type=str, default="charged",
                        choices=["charged", "gravity"])
    parser.add_argument("--max_samples", type=int, default=3000)
    parser.add_argument("--seeds", type=str, default="1,2,3,4,5")
    parser.add_argument("--traj_len", type=int, default=20)
    parser.add_argument("--test_interval", type=int, default=5)
    parser.add_argument("--patience", type=int, default=15)
    parser.add_argument("--n_balls", type=int, default=5)
    parser.add_argument("--num_inputs", type=int, default=1)
    parser.add_argument("--varDT", type=str2bool, default=False)
    parser.add_argument("--dT", type=int, default=1)
    parser.add_argument("--num_timesteps", type=int, default=None)
    parser.add_argument("--outf", type=Path, default="results")
    parser.add_argument("--remat", action="store_true",
                        help="recompute EGNO's forward in the backward "
                             "instead of keeping its activations (large N, "
                             "big fleets)")
    parser.add_argument("--no_hbm_guard", action="store_true",
                        help="keep the requested batch size even when the "
                             "K*B*N^2 rule would scale it down")
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=["fp32", "bf16"],
                        help="as the sequential driver's: fp32 = the "
                             "parity mode; bf16 = fp32 master weights and "
                             "Adam state, bf16 forward and backward, fp32 "
                             "loss")
    parser.add_argument("--checkpoint_every", type=int, default=50,
                        help="save resumable fleet state every N epochs "
                             "(0 disables)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--_die_at_epoch", type=int, default=None,
                        help=argparse.SUPPRESS)  # test hook: a crash mid-run
    # main.build_experiment reads it; the fleet keeps the config's lr
    parser.set_defaults(scale_lr=None)
    return parser.parse_args(argv)


def memory_guard(args, k: int) -> None:
    """The JAX fleet driver's rule (nonode_tpu/fleet_main.py:139-157), kept
    as it is because it changes the batch and so the results: at N >= 20, a
    fleet whose K * batch * N^2 exceeds 2 * 128 * 400 trains on a batch
    scaled down to a multiple of 32 (at least 32) and, for EGNO, with the
    forward recomputed in the backward. ``--no_hbm_guard`` turns it off."""
    pressure = k * args.batch_size * args.n_balls ** 2
    limit = float("inf") if args.no_hbm_guard else 2 * 128 * 400
    if args.n_balls >= 20 and pressure > limit:
        new_b = max(32, int(args.batch_size * limit / pressure // 32 * 32))
        remat_note = ", remat on" if args.model == "egno" else ""
        print(f"HBM guard: batch {args.batch_size} -> {new_b}{remat_note} "
              f"(K={k}, N={args.n_balls})")
        args.batch_size = new_b
        args.remat = args.model == "egno"


def _fleet_state_path(args) -> Path:
    return (args.outf / args.exp_name /
            (f"fleet_state_{args.model}_{args.dataset}_n{args.n_balls}"
             f"_in{args.num_inputs}_varDT{args.varDT}"
             f"_seeds{args.seeds.replace(',', '-')}.pkl"))


def _host(tensors: dict) -> dict:
    return {name: t.detach().cpu().numpy() for name, t in tensors.items()}


def _save_fleet_state(path: Path, epoch, params, opt, best_params, es,
                      alive, rngs, wall_so_far):
    """Atomic pickle of everything a fleet needs to resume bit-identically:
    the stacked parameters, Adam's state per parameter name, the best
    parameters, the vectorized stopper, the alive-seed compaction, every
    seed's host rng stream and the accumulated wall-clock, all as numpy."""
    import pickle
    adam = {}
    for name, p in params.items():
        state = opt.state.get(p)
        if state:
            adam[name] = {key: v.detach().cpu().numpy()
                          for key, v in state.items()}
    state = {"epoch": epoch, "params": _host(params), "adam": adam,
             "best_params": _host(best_params),
             "es": {"best_val": es.best_val, "best_epoch": es.best_epoch,
                    "counter": es.counter, "stopped": es.stopped},
             "alive": np.asarray(alive),
             "rng_states": [r.get_state() for r in rngs],
             "wall_so_far": wall_so_far}
    tmp = path.with_suffix(".pkl.tmp")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    tmp.replace(path)


def _load_fleet_state(path: Path):
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


def _stack_windows(windows):
    """Per-seed EGNO windows (dicts of [S, ...] device tensors) -> one dict
    with a leading seed axis. The out-window truncation is data-dependent
    per seed in principle; at the fleets' configs no seed truncates, so
    unequal shapes raise instead of being padded."""
    out = {}
    for key in windows[0]:
        arrs = [w[key] for w in windows]
        if len({tuple(a.shape) for a in arrs}) != 1:
            raise ValueError(f"per-seed windows differ in shape for {key}")
        out[key] = torch.stack(arrs)
    return out


def main(args):
    device = resolve_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    k = len(seeds)
    memory_guard(args, k)
    if args.model == "segno" and (args.num_inputs > 1 or args.varDT):
        raise NotImplementedError(
            "SEGNO multi-input/varDT fleets are not supported: run those "
            "cells through the sequential driver (nonode_tpu_torch.main), "
            "as the JAX package does")

    def build(generator):
        return build_experiment(args, device, generator)

    # the template replica (fills args.num_timesteps from the config)
    exp = build(seed_everything(seeds[0]))
    if args.model == "egno":
        # EGNO forces varDT off for one input (reference main.py:121)
        args.varDT = bool(args.varDT and args.num_inputs > 1)
    multi = args.model == "egno" and args.num_inputs > 1

    ds_kw = dict(data_dir=args.data_dir, dataset=args.dataset,
                 n_balls=args.n_balls, num_timesteps=args.num_timesteps,
                 num_inputs=args.num_inputs, device=device)
    if args.model == "egno":
        ds_kw.update(varDT=args.varDT, dT=args.dT)
    ds_train = NBodyDataset(partition="train", max_samples=args.max_samples,
                            **ds_kw)
    ds_val = NBodyDataset(partition="val", **ds_kw)
    ds_test = NBodyDataset(partition="test", traj_len=args.traj_len, **ds_kw)

    # remat exists only for EGNO, as in nonode_tpu/fleet_main.py
    fleet = SeedFleet(exp, seeds, remat=args.remat and args.model == "egno")
    params, opt = fleet.init(lambda g: build(g).model)
    best_params = {name: p.detach().clone() for name, p in params.items()}

    rngs = [np.random.RandomState(s) for s in seeds]
    eval_rng = np.random.RandomState(0)
    # validation batches are shared by the seeds: the sequential driver's
    # validation permutation is the unshuffled arange
    vperm = make_perm(eval_rng, len(ds_val), args.batch_size, shuffle=False)

    if not multi:
        # one input: the windows draw nothing from an rng and are the same
        # for every seed
        win_train = exp.windows(ds_train, eval_rng,
                                len(ds_train) // args.batch_size)
        win_val = exp.windows(ds_val, eval_rng, len(vperm))

        def train_fn(p, o, alive_rngs):
            perms = fleet.make_perms(alive_rngs, len(ds_train),
                                     args.batch_size)
            fleet.train_epoch(p, o, ds_train, win_train, perms)

        def val_fn(p, alive_rngs):
            _, vlast = fleet.eval_epoch(p, ds_val, win_val, vperm)
            # the reference's epoch metric is the last-timestep loss
            return vlast.mean(dim=1).cpu().numpy()
    else:
        # several inputs / varDT: each seed draws from its own stream in the
        # sequential driver's order (the train permutation, then the train
        # input offsets; on validation epochs the validation offsets)
        def train_fn(p, o, alive_rngs):
            drawn = [exp.draw_epoch(ds_train, r, args.batch_size)
                     for r in alive_rngs]
            fleet.train_epoch(p, o, ds_train,
                              _stack_windows([w for _, w in drawn]),
                              np.stack([perm for perm, _ in drawn]),
                              per_seed_windows=True)

        def val_fn(p, alive_rngs):
            wins = _stack_windows([exp.windows(ds_val, r, len(vperm))
                                   for r in alive_rngs])
            _, vlast = fleet.eval_epoch(p, ds_val, wins, vperm,
                                        per_seed_windows=True)
            return vlast.mean(dim=1).cpu().numpy()

    es = FleetEarlyStopping(k, patience=args.patience)
    alive = np.arange(k)                 # indices into the seed list
    start_epoch, wall_prev = 0, 0.0
    state_path = _fleet_state_path(args)
    if args.checkpoint_every and state_path.exists():
        st = _load_fleet_state(state_path)
        dev = lambda a: torch.from_numpy(a).to(device)    # noqa: E731
        params = {name: dev(a).requires_grad_()
                  for name, a in st["params"].items()}
        opt = fleet.optimizer(params)
        for name, state in st["adam"].items():
            opt.state[params[name]] = {key: dev(v) if key != "step"
                                       else torch.from_numpy(v)
                                       for key, v in state.items()}
        best_params = {name: dev(a) for name, a in st["best_params"].items()}
        for f_ in ("best_val", "best_epoch", "counter", "stopped"):
            setattr(es, f_, st["es"][f_])
        alive = st["alive"]
        for r, s in zip(rngs, st["rng_states"]):
            r.set_state(s)
        start_epoch, wall_prev = st["epoch"], st["wall_so_far"]
        print(f"resuming fleet from {state_path.name} at epoch {start_epoch} "
              f"(alive {[seeds[i] for i in alive]})")
    t0 = time.time() - wall_prev

    for epoch in range(start_epoch, args.epochs):
        alive_rngs = [rngs[i] for i in alive]
        train_fn(params, opt, alive_rngs)
        # the reference's gate (main.py:156), with its `epoch > 0` quirk: a
        # 1-epoch run never evaluates
        if (epoch % args.test_interval == 0 or epoch == args.epochs - 1) \
                and epoch > 0:
            val = np.full(k, np.inf)
            val[alive] = val_fn(params, alive_rngs)
            improved = es(val, epoch)                          # [K]
            rows = torch.as_tensor(alive[improved[alive]], device=device)
            kept = torch.as_tensor(np.where(improved[alive])[0],
                                   device=device)
            for name, p in params.items():
                best_params[name][rows] = p.detach()[kept]
            print(f"epoch {epoch}: val {np.round(val, 5).tolist()} "
                  f"best {np.round(es.best_val, 5).tolist()} "
                  f"stopped {es.stopped.tolist()}")
            if es.all_stopped:
                print("All seeds early-stopped.")
                break
            newly_stopped = es.stopped[alive]
            if newly_stopped.any():
                keep = np.where(~newly_stopped)[0]
                params, opt = fleet.take(params, opt, keep)
                alive = alive[keep]
                print(f"compacted fleet to {len(alive)} seeds "
                      f"{[seeds[i] for i in alive]}")
        if args.checkpoint_every and epoch > 0 \
                and epoch % args.checkpoint_every == 0:
            _save_fleet_state(state_path, epoch + 1, params, opt,
                              best_params, es, alive, rngs,
                              time.time() - t0)
        if args._die_at_epoch is not None and epoch >= args._die_at_epoch:
            raise RuntimeError(f"test hook: simulated crash at epoch {epoch}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    print(f"fleet training wall-clock: {wall:.1f}s for {k} seeds "
          f"({wall / k:.1f}s/seed equivalent)")

    out_dir = args.outf / args.exp_name
    out_dir.mkdir(parents=True, exist_ok=True)
    records = []
    for i, (seed, p_i) in enumerate(zip(seeds, fleet.split(best_params))):
        exp.model.load_state_dict(p_i, strict=True)
        stem = artifact_stem(args.model, args.dataset, seed, args.n_balls,
                             num_inputs=args.num_inputs, dT=args.dT,
                             varDT=args.varDT,
                             num_timesteps=args.num_timesteps)
        save_params(out_dir / f"{stem}.ckpt", exp.model)
        # several inputs: the seed's stream continues into the test windows,
        # as the sequential driver's one rng; one input draws nothing
        test_rng = rngs[i] if multi else np.random.RandomState(seed)
        test_loss, _, artifact = exp.test_rollout(ds_test, args.batch_size,
                                                  test_rng)
        np.savez(out_dir / f"{stem}_results.npz", **artifact)
        print(f"seed {seed}: best_val {es.best_val[i]:.5f} @ "
              f"{es.best_epoch[i]} test {test_loss:.5f} "
              f"finite {artifact['finite_fraction']:.3f} "
              f"loss_finite {artifact['test_loss_finite']:.5f}")
        records.append({
            "seed": seed, "best_val_loss": float(es.best_val[i]),
            "best_epoch": int(es.best_epoch[i]),
            "test_loss": float(test_loss),
            "finite_fraction": float(artifact["finite_fraction"]),
            "test_loss_finite": float(artifact["test_loss_finite"]),
        })
    # the group is recorded: drop the resume state (kept through the test
    # phase so that a crash there resumes from the last training state)
    if args.checkpoint_every:
        state_path.unlink(missing_ok=True)
    return records


if __name__ == "__main__":
    main(get_args())
