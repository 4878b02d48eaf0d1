"""Mocap training driver: EGNO on CMU motion capture (counterpart of
nonode_tpu/motion_main.py).

``python -m nonode_tpu_torch.motion_main [--config_by_file [path]]
[--device cpu]``

EGNO decodes ``num_timesteps`` frames ending at ``delta_frame`` on the
skeleton + 2-hop graph (a dense [N, N] edge mask, edge attr 1 or 2), node
feature z/10, from the run or walk case's motion pickles under
``--data_dir`` (``motion_run.pkl`` or ``motion.pkl``, and the split pickle,
written there when it is missing). Each epoch takes Adam-L2 steps over a
permutation drawn from ``np.random.RandomState(seed)`` in drop-last
batches; it validates when ``epoch % test_interval == 0`` or at the last
epoch, from epoch 1 on, keeps the best checkpoint and stops after 15
validations without improvement. Then it reloads the best checkpoint, and
one pass over the test batches gives the test loss (the mean of their
MSEs), the results JSON and the ``{targets, preds, test_loss}`` artifact
named by ``analysis.registry.artifact_stem``. The argument names and
defaults are nonode_tpu.motion_main's, plus ``--device``; the bare
``--config_by_file`` loads configs/config_mocap_no.json (read with
``json``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .analysis.registry import artifact_stem
from .data.motion import MotionDynamicsDataset
from .models.egno import EGNO
from .runtime import resolve_device, seed_everything
from .train.checkpoint import EarlyStopping, load_params
from .train.loop import _Experiment, make_perm

DEFAULT_CONFIG = Path(__file__).parent / "configs" / "config_mocap_no.json"


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="EGNO mocap")
    parser.add_argument("--exp_name", type=str, default="mocap_exp")
    parser.add_argument("--batch_size", type=int, default=12)
    parser.add_argument("--epochs", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--nf", type=int, default=128)
    parser.add_argument("--n_layers", type=int, default=6)
    parser.add_argument("--max_training_samples", type=int, default=200)
    parser.add_argument("--data_dir", type=str, default="motion/dataset")
    parser.add_argument("--weight_decay", type=float, default=1e-10)
    parser.add_argument("--delta_frame", type=int, default=30)
    parser.add_argument("--case", type=str, default="run",
                        choices=["walk", "run"])
    parser.add_argument("--num_timesteps", type=int, default=5)
    parser.add_argument("--time_emb_dim", type=int, default=32)
    parser.add_argument("--num_modes", type=int, default=2)
    parser.add_argument("--test_interval", type=int, default=5)
    parser.add_argument("--outf", type=Path, default="results")
    parser.add_argument("--config_by_file", default=None, nargs="?", const="",
                        type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.config_by_file is not None:
        with open(args.config_by_file or DEFAULT_CONFIG) as f:
            overrides = json.load(f)
        for k, v in overrides.items():
            if hasattr(args, k):
                setattr(args, k, v)
    return args


class MotionExperiment(_Experiment):
    """EGNO on mocap samples. A sample's frames are fixed, so an epoch draws
    only its permutation; a batch is an index gather of the device-resident
    split, and the loss is the MSE of the decoded frames against the target
    window (nonode_tpu/motion_main.py:69-83)."""

    def windows(self, ds, rng, num_batches):
        return None

    def batch(self, ds: MotionDynamicsDataset, windows, b: int, idx):
        x0 = ds.x_0[idx]
        return (x0, ds.v_0[idx], ds.node_features(x0), ds.x_t[idx],
                ds.edge_attr, ds.edge_mask)

    def decode(self, batch, params=None):
        """The decoded frames [B, T, N, 3] of a batch."""
        x0, v0, nodes, _, edge_attr, edge_mask = batch
        b, n = x0.shape[:2]
        loc_mean = x0.mean(dim=1, keepdim=True).expand(b, n, 3)
        x, _, _ = self._call(params, x0, v0, nodes,
                             edge_attr.expand(b, *edge_attr.shape), loc_mean,
                             edge_mask=edge_mask)
        return x.transpose(0, 1)

    def _loss(self, batch, params=None):
        loss = ((self.decode(batch, params) - batch[3]) ** 2).mean()
        return loss, loss[None]

    @torch.no_grad()
    def test_pass(self, ds: MotionDynamicsDataset, perm):
        """One decode of every test batch (rows of ``perm``): (the test
        loss, the mean of the batches' MSEs; the artifact {targets, preds,
        test_loss} as numpy arrays)."""
        preds, targets, losses = [], [], []
        for idx in self._perm(perm):
            batch = self.batch(ds, None, 0, idx)
            pred = self.decode(batch)
            losses.append(((pred - batch[3]) ** 2).mean())
            preds.append(pred)
            targets.append(batch[3])
        test_loss = float(torch.stack(losses).mean())
        return test_loss, {"targets": torch.cat(targets).cpu().numpy(),
                           "preds": torch.cat(preds).cpu().numpy(),
                           "test_loss": test_loss}


def build_experiment(args, device, generator) -> MotionExperiment:
    """mocap's EGNO (one node feature, one edge feature) at ``args``'s
    width, its weights drawn from ``generator``, in its experiment."""
    model = EGNO(n_layers=args.n_layers, in_node_nf=1, in_edge_nf=1,
                 hidden_nf=args.nf, num_modes=args.num_modes,
                 num_timesteps=args.num_timesteps,
                 time_emb_dim=args.time_emb_dim, device=device,
                 generator=generator)
    return MotionExperiment(model, lr=args.lr,
                            weight_decay=args.weight_decay)


def main(args):
    device = resolve_device(args.device)
    generator = seed_everything(args.seed)
    rng = np.random.RandomState(args.seed)

    def dataset(part, n):
        return MotionDynamicsDataset(
            data_dir=args.data_dir, partition=part, max_samples=n,
            delta_frame=args.delta_frame, case=args.case,
            num_timesteps=args.num_timesteps, device=device)

    ds_train = dataset("train", args.max_training_samples)
    ds_val = dataset("val", 600)
    ds_test = dataset("test", 600)
    print(f"mocap[{args.case}]: train {len(ds_train)} val {len(ds_val)} "
          f"test {len(ds_test)}, N={ds_train.n_node}, device {device}")

    exp = build_experiment(args, device, generator)
    # built before the clock starts, as main.py does (its first construction
    # imports torch._dynamo)
    exp.optimizer

    save_path = (Path(args.outf) / args.exp_name /
                 f"EGNO_motion_{args.case}_seed={args.seed}.ckpt")
    save_path.parent.mkdir(parents=True, exist_ok=True)
    early = EarlyStopping(patience=15, verbose=True, path=save_path)
    results = {"train loss": [], "val loss": [], "eval epoch": [],
               "test loss": []}
    best_val = 1e8
    t0 = time.time()
    # train losses stay on the device between validations; one transfer
    # per flush
    pending = []

    def flush_pending():
        if pending:
            results["train loss"].extend(
                float(v) for v in torch.stack(pending).cpu().numpy())
            pending.clear()

    for epoch in range(args.epochs):
        perm, windows = exp.draw_epoch(ds_train, rng, args.batch_size)
        losses, _ = exp.train_epoch(ds_train, windows, perm)
        pending.append(losses.mean())
        # the reference's gate (main.py:156), with its `epoch > 0` quirk, and
        # the last epoch's validation so that its improvement is kept
        if (epoch % args.test_interval == 0
                or epoch == args.epochs - 1) and epoch > 0:
            flush_pending()
            vperm, vwin = exp.draw_epoch(ds_val, rng, args.batch_size,
                                         shuffle=False)
            vl = float(exp.eval_epoch(ds_val, vwin, vperm)[0].mean())
            results["eval epoch"].append(epoch)
            results["val loss"].append(vl)
            best_val = min(best_val, vl)
            print(f"epoch {epoch} train {results['train loss'][-1]:.5f} "
                  f"val {vl:.5f} (best {best_val:.5f})")
            early(vl, exp.model)
            if early.early_stop:
                print("Early Stopping.")
                break
    flush_pending()
    print(f"training wall-clock: {time.time() - t0:.1f}s")

    if save_path.exists():
        load_params(save_path, exp.model)
    tperm = make_perm(rng, len(ds_test), args.batch_size, shuffle=False)
    test_loss, artifact = exp.test_pass(ds_test, tperm)
    results["test loss"].append(test_loss)
    print(f"==> test loss: {test_loss:.5f}")
    with open(save_path.with_suffix(".json"), "w") as f:
        json.dump(results, f, indent=4)

    # the drivers' artifact schema, so that analysis.registry groups mocap
    # seeds as it does N-body cells: the N=31 joints stand for n_part
    stem = artifact_stem("egno", f"motion_{args.case}", args.seed,
                         ds_test.n_node, num_timesteps=args.num_timesteps)
    np.savez(save_path.parent / f"{stem}_results.npz", **artifact)
    print(f"trajectory artifact saved to {save_path.parent / stem}"
          f"_results.npz")
    return best_val, test_loss


if __name__ == "__main__":
    a = get_args()
    best_val, test_loss = main(a)
    print(f"Best Val Loss: {best_val}\nTest Loss: {test_loss}")
