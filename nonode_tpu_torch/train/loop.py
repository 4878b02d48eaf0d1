"""EGNO training, validation and evaluation: batch gather, forward, loss,
Adam-L2 epochs, windowed rollout and the test rollout artifact (counterpart
of the EGNO half of nonode_tpu/train/loop.py).

The split lives on the device; a batch is an index gather. The JAX
package's whole-epoch ``lax.scan`` over batches is a Python loop here whose
per-batch losses stay on the device: an epoch makes no host sync. The
rollout's scan over windows is a Python loop too; everything in a window
stays on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.nbody import NBodyDataset
from ..models.egno import EGNO
from .metrics import conserved_energy, pearson_correlation_batch


def make_perm(rng: np.random.RandomState, n: int, batch_size: int,
              shuffle: bool = True) -> np.ndarray:
    """[num_batches, B] index array; drop_last=True like the reference
    train loaders."""
    idx = rng.permutation(n) if shuffle else np.arange(n)
    nb = n // batch_size
    return idx[: nb * batch_size].reshape(nb, batch_size).astype(np.int64)


def prepare_inputs(loc, vel, edge_w, charges=None):
    """Feature construction (main_simulation_simple_no.py:311-339).

    loc, vel: [..., N, 3]; edge_w: [..., N, N, 1]; charges: [B, N, 1] or None.
    Returns (nodes [..., N, F], edge_attr [..., N, N, 2], loc_mean [..., N, 3]).
    """
    speed = torch.sqrt((vel ** 2).sum(-1, keepdim=True))
    if charges is not None:
        nodes = torch.cat([speed, charges.expand(speed.shape)], dim=-1)
    else:
        nodes = speed
    diff = loc[..., :, None, :] - loc[..., None, :, :]
    dist = (diff ** 2).sum(-1, keepdim=True)
    edge_attr = torch.cat([edge_w.expand(dist.shape), dist], dim=-1)
    loc_mean = loc.mean(dim=-2, keepdim=True).expand(loc.shape)
    return nodes, edge_attr, loc_mean


def _gather_window(arr, idx, frames):
    """arr: [S, F, ...]; idx: [B]; frames: [B, K] -> [B, K, ...]."""
    return arr[idx[:, None], frames]


def _finite_metrics(artifact, bound_mult=10.0):
    """Companion metrics for diverging autoregressive rollouts: the loss over
    samples whose predictions stayed finite and within ``bound_mult`` x the
    ground-truth coordinate range, and the fraction of such samples."""
    preds = artifact["preds"]
    targets = artifact["targets"][:, : preds.shape[1]]
    bound = bound_mult * max(float(np.abs(targets).max()), 1.0)
    with np.errstate(invalid="ignore"):
        ok = (np.isfinite(preds) & (np.abs(preds) <= bound)).all(axis=(1, 2, 3))
    out = {"finite_fraction": float(ok.mean())}
    if ok.any():
        d = preds[ok] - targets[ok]
        out["test_loss_finite"] = float((d ** 2).mean())
    else:
        out["test_loss_finite"] = float("nan")
    return out


class EGNOExperiment:
    """EGNO training, validation and evaluation against a device-resident
    dataset. The model's device is the experiment's device; the experiment
    owns the Adam-L2 optimizer of the model's parameters."""

    def __init__(self, model: EGNO, lr: float = 1e-4,
                 weight_decay: float = 1e-8):
        self.model = model
        self.device = next(model.parameters()).device
        self.lr = lr
        self.weight_decay = weight_decay

    @functools.cached_property
    def optimizer(self) -> torch.optim.Adam:
        """Adam with L2: wd * p joins the gradient before the moment updates
        (not AdamW), as nonode_tpu's optax.chain(add_decayed_weights, adam).
        Made at the first training step: the first Adam a process builds
        imports torch._dynamo, seconds of host time that an evaluation-only
        run does not need."""
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                weight_decay=self.weight_decay)

    def epoch_index_arrays(self, ds: NBodyDataset, rng: np.random.RandomState):
        """Host-side per-epoch index arrays: frames_in [S, L], t_in [S, L],
        out_frames [S, T'], t_out [S, T']."""
        s = len(ds)
        if ds.num_inputs > 1:
            frames_in, t_in = ds.sample_input_offsets(rng)
        else:
            frames_in = np.full((s, 1), ds.start, np.int64)
            t_in = np.zeros((s, 1), np.float32)
        base_out = ds.out_indices()
        shift = frames_in[:, -1:] - ds.start
        out_frames = base_out[None, :] + shift
        # static-shape truncation: drop tail columns any sample would index
        # past the trajectory end
        valid = (out_frames < ds.n_frames).all(axis=0)
        out_frames = out_frames[:, valid]
        t_out = (out_frames - frames_in[:, -1:]).astype(np.float32)
        return {"frames_in": frames_in.astype(np.int64), "t_in": t_in,
                "out_frames": out_frames.astype(np.int64), "t_out": t_out}

    def _batch(self, ds_arrays, idx_arrays, idx):
        loc_all, vel_all, charges_all, w_all = ds_arrays
        frames_in = idx_arrays["frames_in"][idx]           # [B, L]
        loc_in = _gather_window(loc_all, idx, frames_in)   # [B, L, N, 3]
        vel_in = _gather_window(vel_all, idx, frames_in)
        charges = charges_all[idx]
        w = w_all[idx]
        loc_out = _gather_window(loc_all, idx, idx_arrays["out_frames"][idx])
        t_in = idx_arrays["t_in"][idx]
        t_out = idx_arrays["t_out"][idx]
        # BATCH-GLOBAL time normalisation: the reference subtracts the
        # batch-wide in_indices.max() (main_simulation_simple_no.py:208-209);
        # the stored t_in/t_out are per sample, so add last_i - max_batch(last).
        last = frames_in[:, -1:]
        corr = (last - last.max()).to(torch.float32)       # [B, 1] <= 0
        return (loc_in, vel_in, charges, w, loc_out, t_in + corr, t_out + corr)

    def _forward(self, loc_in, vel_in, charges, w, t_in, t_out):
        if self.model.num_inputs > 1:
            loc = loc_in.transpose(0, 1)                   # [L, B, N, 3]
            vel = vel_in.transpose(0, 1)
            nodes, edge_attr, loc_mean = prepare_inputs(
                loc, vel, w[None], charges[None])
            return self.model(loc, vel, nodes, edge_attr, loc_mean,
                              timesteps_out=t_out, timesteps_in=t_in)
        loc = loc_in[:, 0]
        vel = vel_in[:, 0]
        nodes, edge_attr, loc_mean = prepare_inputs(loc, vel, w, charges)
        return self.model(loc, vel, nodes, edge_attr, loc_mean,
                          timesteps_out=t_out)

    def _loss(self, batch):
        """(mean over timesteps, per-timestep losses [T]); the mean is the
        backprop target, the last timestep's loss the reported epoch loss
        (main_simulation_simple_no.py:287)."""
        loc_in, vel_in, charges, w, loc_out, t_in, t_out = batch
        t_model = self.model.num_timesteps
        x, _, _ = self._forward(loc_in, vel_in, charges, w, t_in,
                                t_out[:, :t_model])
        pred = x.transpose(0, 1)                           # [B, T, N, 3]
        target = loc_out[:, :t_model]
        losses = ((pred - target) ** 2).mean(dim=(0, 2, 3))   # [T]
        return losses.mean(), losses

    def _device_arrays(self, ds: NBodyDataset, idx_np: dict, perm):
        return ((ds.loc, ds.vel, ds.charges, ds.edge_weights),
                {k: torch.from_numpy(v).to(self.device)
                 for k, v in idx_np.items()},
                torch.from_numpy(np.asarray(perm, np.int64)).to(self.device))

    def train_epoch(self, ds: NBodyDataset, idx_np: dict, perm):
        """One Adam step per row of ``perm`` [num_batches, B]. Returns the
        per-batch (mean_loss, last_step_loss) as device tensors; nothing is
        synced to the host."""
        ds_arrays, idx_arrays, perm = self._device_arrays(ds, idx_np, perm)
        losses, last = [], []
        for idx in perm:
            batch = self._batch(ds_arrays, idx_arrays, idx)
            self.optimizer.zero_grad(set_to_none=True)
            loss, per_step = self._loss(batch)
            loss.backward()
            self.optimizer.step()
            losses.append(loss.detach())
            last.append(per_step[-1].detach())
        return torch.stack(losses), torch.stack(last)

    @torch.no_grad()
    def eval_epoch(self, ds: NBodyDataset, idx_np: dict, perm):
        """The per-batch (mean_loss, last_step_loss) of ``perm`` without
        updates, as device tensors."""
        ds_arrays, idx_arrays, perm = self._device_arrays(ds, idx_np, perm)
        losses, last = [], []
        for idx in perm:
            loss, per_step = self._loss(self._batch(ds_arrays, idx_arrays,
                                                    idx))
            losses.append(loss)
            last.append(per_step[-1])
        return torch.stack(losses), torch.stack(last)

    @torch.no_grad()
    def rollout(self, batch, traj_len: int, dataset_kind: str):
        """Autoregressive windowed rollout (main_simulation_simple_no.py:342-384).

        Feeds the decoded frames at the input-offset positions back as the
        next window's inputs and evaluates the energy oracle per decoded
        frame. Returns (locs_pred [traj_len*T, B, N, 3],
        energies [traj_len*T, B, 1]).
        """
        loc, vel, charges, w, _, t_in, t_out_all = batch
        t_model = self.model.num_timesteps
        # feedback frames at timesteps_in - 1 (negative => from the end)
        fb = (t_in.to(torch.int64) - 1) % t_model          # [B, L]
        rows = torch.arange(fb.shape[0], device=fb.device)[:, None]
        xs, es = [], []
        for i in range(traj_len):
            # per-window output timesteps, shifted back by i*T
            t_out = t_out_all[:, i * t_model:(i + 1) * t_model] - i * t_model
            x, v, _ = self._forward(loc, vel, charges, w, t_in, t_out)
            es.append(conserved_energy(dataset_kind, x, v, charges))  # [T, B]
            xs.append(x)
            loc, vel = x[fb, rows], v[fb, rows]            # [B, L, N, 3]
        locs_pred = torch.cat(xs)
        energies = torch.cat(es)[..., None]
        return locs_pred, energies

    @torch.no_grad()
    def test_rollout(self, ds: NBodyDataset, batch_size: int,
                     rng: np.random.RandomState):
        """Full test evaluation. Returns (test_loss, avg_num_steps, artifact),
        artifact = {targets, preds, energy_conservation, test_loss} plus the
        finite-sample companions, as numpy arrays."""
        t_model = self.model.num_timesteps
        idx_np = self.epoch_index_arrays(ds, rng)
        avail = idx_np["out_frames"].shape[1]
        traj_len = min(ds.traj_len, avail // t_model)
        cut = int(0.4 * ds.traj_len * t_model)

        ds_arrays = (ds.loc, ds.vel, ds.charges, ds.edge_weights)
        idx_arrays = {k: torch.from_numpy(v).to(ds.device)
                      for k, v in idx_np.items()}

        n = len(ds)
        tot_loss = tot_steps = count = 0.0
        targets_l, preds_l, energies_l = [], [], []
        for s0 in range(0, n - batch_size + 1, batch_size):   # drop_last
            idx = torch.arange(s0, s0 + batch_size, device=ds.device)
            batch = self._batch(ds_arrays, idx_arrays, idx)
            locs_pred, energies = self.rollout(batch, traj_len, ds.dataset)
            loc_true = batch[4]                            # [B, T', N, 3]
            tcur = locs_pred.shape[0]
            truth = loc_true.transpose(0, 1)[:tcur]        # [T', B, N, 3]

            b, nn_ = loc_true.shape[0], loc_true.shape[2]
            _, avg_steps, _ = pearson_correlation_batch(
                locs_pred.reshape(tcur, -1, 3), truth.reshape(tcur, -1, 3), nn_)

            sup = min(cut, tcur)
            losses = ((locs_pred[:sup] - truth[:sup]) ** 2).mean(dim=(1, 2, 3))
            loss = losses.mean()

            tot_loss += float(loss) * b
            tot_steps += float(avg_steps) * b
            count += b
            targets_l.append(truth.transpose(0, 1).cpu().numpy())
            preds_l.append(locs_pred[:sup].transpose(0, 1).cpu().numpy())
            energies_l.append(energies[:sup].transpose(0, 1).cpu().numpy())

        test_loss = tot_loss / count
        artifact = {
            "targets": np.concatenate(targets_l),
            "preds": np.concatenate(preds_l),
            "energy_conservation": np.concatenate(energies_l),
            "test_loss": test_loss,
        }
        artifact.update(_finite_metrics(artifact))
        return test_loss, tot_steps / count, artifact
