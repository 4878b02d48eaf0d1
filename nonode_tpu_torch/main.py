"""Experiment entry point for EGNO and SEGNO: training and evaluation
(counterpart of nonode_tpu/main.py:51-378).

``python -m nonode_tpu_torch.main --model {egno,segno} [--only_test true]
[--device cpu]``

Seeds everything and builds the model on the device. Unless
``--only_test``, it trains on the train split with Adam-L2, validates every
``--test_interval`` epochs (from epoch 1 on, as the reference), saves the
best checkpoint and stops early after 15 validations without improvement.
Then it loads the checkpoint at its save path when it exists (else keeps
the weights initialised from ``--seed``), runs the windowed test rollout,
and writes a results JSON and the ``{targets, preds, energy_conservation,
test_loss}`` artifact (``_results.npz``) under ``--outf``. For SEGNO,
``--traj_len <= 0`` runs the plain test epoch instead and writes no
artifact; several inputs fuse by attention, and with ``--varDT`` their
segment lengths are drawn per batch. The argument names and defaults
are nonode_tpu.main's, plus ``--device``; ``--config`` defaults to the
built-in model_confs.yaml values; ``--config_by_file`` merges a JSON preset
over the arguments and the model config.

``--dp D --space S`` runs D x S ranks (parallel/mesh.py: new processes, or
the group ``torchrun`` made): each batch over D, each graph's particles over
S, the results the single process's. Only rank 0 prints, logs, saves the
checkpoint and writes the results; main returns rank 0's values.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from .analysis.registry import artifact_stem
from .config import apply_preset, load_model_config, overlay
from .data.nbody import NBodyDataset
from .models.egno import EGNO
from .models.segno import SEGNO
from .parallel import mesh as meshes
from .runtime import resolve_device, seed_everything
from .train.checkpoint import EarlyStopping, load_params
from .train.loop import EGNOExperiment, SEGNOExperiment
from .utils.logging import RunLogger


def str2bool(value):
    if isinstance(value, bool):
        return value
    if value.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if value.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"Invalid boolean value: {value}")


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Main module for SEGNO and EGNO")
    parser.add_argument("--model", type=str, choices=["segno", "egno"],
                        required=True)
    parser.add_argument("--exp_name", type=str, default="0exp_new")
    parser.add_argument("--config", type=str, default=None,
                        help="model_confs.yaml-schema file; default: the "
                             "built-in model_confs.yaml values")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--data_dir", type=Path, default="data")
    parser.add_argument("--dataset", type=str, default="charged",
                        choices=["charged", "gravity"])
    parser.add_argument("--max_samples", type=int, default=3000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--only_test", type=str2bool, default=False)
    parser.add_argument("--traj_len", type=int, default=20)
    parser.add_argument("--test_interval", type=int, default=5)
    parser.add_argument("--n_balls", type=int, default=5)
    parser.add_argument("--outf", type=Path, default="results")
    parser.add_argument("--load_checkpoint", type=str2bool, default=False)
    parser.add_argument("--scale_lr", type=float, default=None)
    parser.add_argument("--dT", type=int, default=1)
    parser.add_argument("--num_timesteps", type=int, default=None)
    parser.add_argument("--varDT", type=str2bool, default=False)
    parser.add_argument("--num_inputs", type=int, default=1)
    parser.add_argument("--use_wb", type=str2bool, default=False)
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=["fp32", "bf16"],
                        help="fp32: the parity mode; bf16: fp32 master "
                             "weights and Adam state, bf16 forward and "
                             "backward, fp32 loss (the rollout stays fp32)")
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--space", type=int, default=1)
    parser.add_argument("--config_by_file", default=None, nargs="?", const="",
                        type=str,
                        help="JSON preset merged over existing args; the bare "
                             "flag loads configs/config_simulation_simple_no"
                             ".json")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.config_by_file is not None:
        args._cfg_overrides = apply_preset(args, args.config_by_file or None)
    return args


def _check_args(args):
    if args.model == "egno" and args.traj_len <= 0:
        # as nonode_tpu/main.py:336-340: the EGNO test window is empty there
        raise ValueError(
            "EGNO requires --traj_len >= 1: at traj_len=0 the test dataset's "
            "out window is empty (the reference crashes on this config too, "
            "main_simulation_simple_no.py:274-287)")
    # nonode_tpu/main.py:209-214 asserts these
    if args.batch_size % args.dp:
        raise ValueError(f"batch_size {args.batch_size} not divisible by "
                         f"dp={args.dp}")
    if args.n_balls % args.space:
        raise ValueError(f"n_balls {args.n_balls} not divisible by "
                         f"space={args.space}")


def build_experiment(args, device, generator):
    """The model that ``args`` name at its config's width (model_confs.yaml,
    ``--config``, the preset), its weights drawn from ``generator``, in its
    experiment. Fills ``args.num_timesteps`` in from the config; EGNO takes
    varDT only with several inputs (main.py:121)."""
    cfg = load_model_config(args.model, args.config)
    over = getattr(args, "_cfg_overrides", None)
    if over:
        cfg = overlay(cfg, over)
    if args.num_timesteps is None:
        args.num_timesteps = cfg.num_timesteps
    if args.scale_lr:
        cfg = dataclasses.replace(cfg, lr=cfg.lr * args.scale_lr)
    kw = dict(device=device, generator=generator)
    dtype = torch.bfloat16 if args.precision == "bf16" else None
    if args.model == "segno":
        model = SEGNO(in_node_nf=cfg.in_node_nf, in_edge_nf=cfg.in_edge_nf,
                      hidden_nf=cfg.hidden_nf, recurrent=cfg.recurrent,
                      tanh=cfg.tanh,
                      multiple_agg="attn" if args.num_inputs > 1 else None,
                      **kw)
        return SEGNOExperiment(model, num_timesteps=args.num_timesteps,
                               varDT=args.varDT, lr=cfg.lr,
                               weight_decay=cfg.weight_decay,
                               compute_dtype=dtype)
    model = EGNO(n_layers=cfg.n_layers, in_node_nf=cfg.in_node_nf,
                 in_edge_nf=cfg.in_edge_nf, hidden_nf=cfg.hidden_nf,
                 num_modes=cfg.num_modes, num_timesteps=args.num_timesteps,
                 time_emb_dim=cfg.time_emb_dim, num_inputs=args.num_inputs,
                 varDT=bool(args.varDT and args.num_inputs > 1),
                 with_v=cfg.with_v, flat=cfg.flat, norm=cfg.norm, **kw)
    return EGNOExperiment(model, lr=cfg.lr, weight_decay=cfg.weight_decay,
                          compute_dtype=dtype)


def main(args):
    """Train and test as the arguments say; (best validation loss, test
    loss, best epoch). With ``--dp``/``--space`` the ranks run
    ``_main_on_rank`` and rank 0's values come back."""
    _check_args(args)
    device = resolve_device(args.device)
    if args.dp * args.space > 1:
        return meshes.launch(_main_on_rank, (args,), args.dp, args.space,
                             device)
    return _main_on_rank(None, args)


def _main_on_rank(mesh, args):
    """``main`` on one rank of ``mesh`` (None: the single process)."""
    lead = mesh is None or mesh.rank == 0
    device = resolve_device(args.device if mesh is None else mesh.device)
    print(args)
    seed = args.seed
    generator = seed_everything(seed)
    rng = np.random.RandomState(seed)
    exp = build_experiment(args, device, generator)
    model = exp.model

    model_save_path = (args.outf / args.exp_name /
                       (artifact_stem(args.model, args.dataset, seed,
                                      args.n_balls, args.num_inputs, args.dT,
                                      args.varDT, args.num_timesteps)
                        + ".ckpt"))
    model_save_path.parent.mkdir(parents=True, exist_ok=True)
    print(f"Model saved to {model_save_path}")
    early_stopping = EarlyStopping(patience=15, verbose=True,
                                   path=model_save_path, saves=lead)
    results = {"eval epoch": [], "val loss": [], "test loss": [],
               "train loss": []}
    best_val_loss = 1e8
    best_epoch = 0

    ds_kw = dict(data_dir=args.data_dir, dataset=args.dataset,
                 n_balls=args.n_balls, num_timesteps=args.num_timesteps,
                 num_inputs=args.num_inputs, device=device)
    if args.model == "egno":
        # EGNO forces varDT off for one input (main.py:121), after the
        # checkpoint is named, as nonode_tpu/main.py:149-184; SEGNO's
        # datasets take neither varDT nor dT
        args.varDT = bool(args.varDT and args.num_inputs > 1)
        ds_kw.update(varDT=args.varDT, dT=args.dT)
    if not args.only_test:
        ds_train = NBodyDataset(partition="train",
                                max_samples=args.max_samples, **ds_kw)
        ds_val = NBodyDataset(partition="val", **ds_kw)
    ds_test = NBodyDataset(partition="test", traj_len=args.traj_len, **ds_kw)
    print(f"Num particles: {args.n_balls}, VarDT: {args.varDT}, "
          f"Num inputs: {args.num_inputs}, "
          f"Num timesteps: {args.num_timesteps}, dT: {args.dT}, "
          f"device: {device}")

    logger = RunLogger(args.outf / args.exp_name, model_save_path.stem,
                       config=vars(args), use_wandb=args.use_wb,
                       active=lead)

    if args.load_checkpoint and model_save_path.exists():
        print(f"Loading model from {model_save_path}")
        load_params(model_save_path, model)
    elif not args.only_test:
        print("Training from scratch.")
    if mesh is not None:
        meshes.apply_mesh(exp, mesh)
    if not args.only_test:
        # the optimizer exists before the clock starts, as the JAX driver's
        # exp.init does (its first construction imports torch._dynamo)
        exp.optimizer

    def run_epoch(ds, train):
        perm, windows = exp.draw_epoch(ds, rng, args.batch_size,
                                       shuffle=train)
        step = exp.train_epoch if train else exp.eval_epoch
        _, last = step(ds, windows, perm)
        # the reference reports the last frame's loss as the epoch loss
        return last.mean()

    # Train losses stay on the device between validations and reach the
    # host in one transfer per flush, as nonode_tpu/main.py:269-286.
    pending = []

    def flush_train_losses():
        if not pending:
            return
        vals = torch.stack([d for _, d in pending]).cpu().numpy()
        for (ep, _), v in zip(pending, vals):
            v = float(v)
            results["train loss"].append(v)
            print(f"train epoch {ep} avg loss: {v:.5f}")
            logger.log({"train_loss": v}, step=ep)
        pending.clear()

    t_start = time.time()
    if not args.only_test:
        try:
            for epoch in range(args.epochs):
                pending.append((epoch, run_epoch(ds_train, train=True)))
                # the reference's gate (main.py:156), with its `epoch > 0`
                # quirk: a 1-epoch run never validates
                if (epoch % args.test_interval == 0
                        or epoch == args.epochs - 1) and epoch > 0:
                    flush_train_losses()
                    val_loss = float(run_epoch(ds_val, train=False))
                    print(f"==> val epoch {epoch} avg loss: {val_loss:.5f}")
                    results["eval epoch"].append(epoch)
                    results["val loss"].append(val_loss)
                    logger.log({"val_loss": val_loss}, step=epoch)
                    if val_loss < best_val_loss:
                        best_val_loss = val_loss
                        best_epoch = epoch
                    print("*** Best Val Loss: %.5f \t  Best epoch %d"
                          % (best_val_loss, best_epoch))
                    early_stopping(val_loss, model)
                    if early_stopping.early_stop:
                        print("Early Stopping.")
                        break
        finally:
            flush_train_losses()
        print(f"training wall-clock: {time.time() - t_start:.1f}s")

    # as nonode_tpu/main.py:323-324, the test rollout evaluates the
    # checkpoint at the save path whenever it exists (every rank, once rank
    # 0 has written it)
    if mesh is not None:
        mesh.barrier()
    if model_save_path.exists():
        print(f"Loading model from {model_save_path}")
        load_params(model_save_path, model)
    else:
        print(f"No checkpoint at {model_save_path}; weights as they are "
              f"(initialised from --seed {seed}).")

    t0 = time.time()
    if args.traj_len <= 0:
        # SEGNO only: the reference runs a plain (non-rollout) test epoch and
        # saves no artifact (main.py:176,188; nonode_tpu/main.py:326-344)
        test_loss = float(run_epoch(ds_test, train=False))
        avg_num_steps, artifact = 0.0, {}
    else:
        test_loss, avg_num_steps, artifact = exp.test_rollout(
            ds_test, args.batch_size, rng)
    print(f"==> test rollout loss: {test_loss:.5f} "
          f"avg_num_steps: {avg_num_steps:.2f} "
          f"finite_fraction: {artifact.get('finite_fraction', 1.0):.3f} "
          f"loss_finite: "
          f"{artifact.get('test_loss_finite', float('nan')):.5f} "
          f"({time.time() - t0:.1f}s)")
    results["test loss"].append(test_loss)
    logger.log({"test_loss": test_loss, "avg_num_steps": avg_num_steps,
                "finite_fraction": artifact.get("finite_fraction", 1.0)})
    if not lead:
        return best_val_loss, test_loss, best_epoch

    with open(model_save_path.with_suffix(".json"), "w") as f:
        f.write(json.dumps(results, indent=4))
    if args.traj_len > 0:
        traj_file = (model_save_path.parent
                     / f"{model_save_path.stem}_results.npz")
        np.savez(traj_file, **artifact)
        print(f"trajectory artifact saved to {traj_file}")
        logger.log_artifact(traj_file)
    logger.finish()
    return best_val_loss, test_loss, best_epoch


if __name__ == "__main__":
    a = get_args()
    best_val_loss, test_loss, best_epoch = main(a)
    print(f"Best Val Loss: {best_val_loss}")
    print(f"Best Epoch: {best_epoch}")
    print(f"Test Loss: {test_loss}")
