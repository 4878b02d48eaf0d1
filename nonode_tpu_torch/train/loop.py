"""EGNO and SEGNO training, validation and evaluation: batch gather,
forward, loss, Adam-L2 epochs, windowed rollout and the test rollout
artifact (counterpart of nonode_tpu/train/loop.py).

The split lives on the device; a batch is an index gather. The JAX
package's whole-epoch ``lax.scan`` over batches is a Python loop here whose
per-batch losses stay on the device: an epoch makes no host sync. The
rollout's scan over windows is a Python loop too; everything in a window
stays on the device. Input frames and segment lengths are host integers
drawn from the driver's numpy ``RandomState``.

``compute_dtype`` (``--precision bf16``) is the JAX package's cast-everything
policy: the parameters stay fp32 leaves, and so does Adam's state; ``_loss``
casts them and the batch's inputs explicitly for its forward and backward,
and takes the loss in fp32. Not ``torch.autocast``, whose per-op lists keep
reductions and pointwise ops in fp32 where JAX runs them in bf16. Only
``_loss`` casts: the rollouts stay fp32, as in JAX.

``_loss`` also takes the parameters as an argument (a name -> tensor dict,
through ``torch.func.functional_call``), so that a seed fleet can vmap it
over stacked per-seed parameters (parallel/fleet.py).

With a mesh (``--dp``/``--space``, parallel/mesh.py) the experiment's
batches are global, as one process builds them, and ``shard`` cuts each to
the rank's rows and particles. ``_loss`` returns the rank's share of the
global mean (its sum over the global count; one formula with or without a
mesh), the gradients and the reported losses are summed over the world,
and the rollouts gather the predictions of every rank, so that the
energies, the correlation and the artifact are computed on the global state
in the single process's batch and particle order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.nbody import NBodyDataset
from ..models.egno import EGNO
from ..models.segno import SEGNO
from .metrics import conserved_energy, pearson_correlation_batch


def make_perm(rng: np.random.RandomState, n: int, batch_size: int,
              shuffle: bool = True) -> np.ndarray:
    """[num_batches, B] index array; drop_last=True like the reference
    train loaders."""
    idx = rng.permutation(n) if shuffle else np.arange(n)
    nb = n // batch_size
    return idx[: nb * batch_size].reshape(nb, batch_size).astype(np.int64)


def prepare_inputs(loc, vel, edge_w, charges=None, rows=None):
    """Feature construction (main_simulation_simple_no.py:311-339).

    loc, vel: [..., N, 3]; edge_w: [..., N, N, 1]; charges: [B, N, 1] or None.
    Returns (nodes [..., N, F], edge_attr [..., N, N, 2], loc_mean [..., N, 3]).
    ``rows`` (ops.dense_graph.ReceiverRows): loc, vel, charges hold the
    receivers [i0, i0 + ni) and edge_w [..., ni, N, 1]; the distances take
    the gathered senders, loc_mean the mean over all N.
    """
    speed = torch.sqrt((vel ** 2).sum(-1, keepdim=True))
    if charges is not None:
        nodes = torch.cat([speed, charges.expand(speed.shape)], dim=-1)
    else:
        nodes = speed
    senders = loc if rows is None else rows.gather(loc)
    diff = loc[..., :, None, :] - senders[..., None, :, :]
    dist = (diff ** 2).sum(-1, keepdim=True)
    edge_attr = torch.cat([edge_w.expand(dist.shape), dist], dim=-1)
    if rows is None:
        loc_mean = loc.mean(dim=-2, keepdim=True)
    else:
        loc_mean = rows.node_sum(loc.sum(dim=-2, keepdim=True)) / rows.n
    return nodes, edge_attr, loc_mean.expand(loc.shape)


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


def zero_missing_grads(params) -> None:
    """Give every parameter without a gradient (EGNO's last node MLP feeds
    no loss term) a zero one: ``torch.optim.Adam`` skips a parameter whose
    ``.grad`` is None, where optax's Adam-L2 decays every leaf."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


class _Experiment:
    """A model's experiment against a device-resident dataset. The model's
    device is the experiment's device; the experiment owns the Adam-L2
    optimizer of the model's parameters.

    Every model answers the same calls: ``draw_epoch`` (the permutation and
    the model's input ``windows``), ``batch``, ``train_epoch`` and
    ``eval_epoch``, ``rollout`` and ``test_rollout``. How a model draws its
    windows and steps its forward stays behind them.

    ``mesh`` (parallel/mesh.py ``apply_mesh``): the batches are cut to the
    rank's share (``_shard``, per model) and the losses and gradients
    summed over the world."""

    def __init__(self, model, lr: float, weight_decay: float,
                 compute_dtype: torch.dtype | None = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.lr = lr
        self.weight_decay = weight_decay
        self.compute_dtype = compute_dtype
        self.mesh = None

    @functools.cached_property
    def optimizer(self) -> torch.optim.Adam:
        """Adam with L2: wd * p joins the gradient before the moment updates
        (not AdamW), as nonode_tpu's optax.chain(add_decayed_weights, adam).
        Made at the first training step: the first Adam a process builds
        imports torch._dynamo, seconds of host time that an evaluation-only
        run does not need."""
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                weight_decay=self.weight_decay)

    def _adam_step(self, loss):
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            self.mesh.all_reduce_grads(self.model.parameters())
        zero_missing_grads(self.model.parameters())
        self.optimizer.step()

    # ---------- the mesh ----------

    def shard(self, batch):
        """The rank's share of a global batch (the batch itself without a
        mesh)."""
        return batch if self.mesh is None else self._shard(batch)

    def _shards(self) -> int:
        """The ranks a global batch is cut over: a rank's count times this
        is the global count."""
        return 1 if self.mesh is None else self.mesh.world

    def _rows(self, ni: int):
        """The receiver rows of a rank holding ``ni`` particles (None: the
        whole graph)."""
        return None if self.mesh is None else self.mesh.rows(ni)

    def _summed(self, *tensors):
        """Per-rank shares summed over the world, in one reduction (as
        they are without a mesh)."""
        if self.mesh is None:
            return tensors
        flat = self.mesh.all_reduce(torch.stack(tensors))
        return tuple(flat)

    def _gathered(self, t, batch_dim, node_dim):
        """Every rank's share of a global [.., B, .., N, ..] tensor (itself
        without a mesh)."""
        if self.mesh is None:
            return t
        return self.mesh.gather_batch(t, batch_dim, node_dim)

    def step(self, batch):
        """One Adam-L2 step on a global batch: (loss, per-frame losses),
        this rank's shares, detached."""
        loss, per_frame = self._loss(self.shard(batch))
        self._adam_step(loss)
        return loss.detach(), per_frame.detach()

    def draw_epoch(self, ds: NBodyDataset, rng: np.random.RandomState,
                   batch_size: int, shuffle: bool = True):
        """(perm [NB, B], windows) of one epoch, drawn from ``rng`` in the
        JAX driver's order: the permutation, then the model's windows."""
        perm = make_perm(rng, len(ds), batch_size, shuffle)
        return perm, self.windows(ds, rng, len(perm))

    def train_epoch(self, ds: NBodyDataset, windows, perm):
        """One Adam step per row of ``perm`` [NB, B] on ``windows``. Returns
        the per-batch (loss, reported loss: the last predicted frame's) as
        device tensors; nothing is synced to the host. With a mesh, both
        are summed over the world once, at the end."""
        losses, last = [], []
        for b, idx in enumerate(self._perm(perm)):
            loss, per_frame = self.step(self.batch(ds, windows, b, idx))
            losses.append(loss)
            last.append(per_frame[-1])
        return self._summed(torch.stack(losses), torch.stack(last))

    @torch.no_grad()
    def eval_epoch(self, ds: NBodyDataset, windows, perm):
        """``train_epoch``'s per-batch losses without updates."""
        losses, last = [], []
        for b, idx in enumerate(self._perm(perm)):
            loss, per_frame = self._loss(self.shard(
                self.batch(ds, windows, b, idx)))
            losses.append(loss)
            last.append(per_frame[-1])
        return self._summed(torch.stack(losses), torch.stack(last))

    def _perm(self, perm):
        return torch.from_numpy(np.asarray(perm, np.int64)).to(self.device)

    def _cast(self, params, inputs):
        """(params, inputs) for the loss's forward: in ``compute_dtype``
        when it is set (``params`` None: the model's own), else as given."""
        if self.compute_dtype is None:
            return params, inputs
        if params is None:
            params = dict(self.model.named_parameters())
        dt = self.compute_dtype
        return ({k: p.to(dt) for k, p in params.items()},
                tuple(a.to(dt) for a in inputs))

    def _call(self, params, *args, **kwargs):
        """The model on ``params`` (None: its own parameters)."""
        if params is None:
            return self.model(*args, **kwargs)
        return torch.func.functional_call(self.model, params, args, kwargs)


class EGNOExperiment(_Experiment):
    """EGNO training, validation and evaluation. Its windows are per sample:
    the input frames and output frames of every sample of the split."""

    def __init__(self, model: EGNO, lr: float = 1e-4,
                 weight_decay: float = 1e-8,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(model, lr, weight_decay, compute_dtype)

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

    def windows(self, ds: NBodyDataset, rng: np.random.RandomState,
                num_batches: int):
        """``epoch_index_arrays`` on the device (per sample, so
        ``num_batches`` does not enter)."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.epoch_index_arrays(ds, rng).items()}

    def batch(self, ds: NBodyDataset, windows, b: int, idx):
        """The batch of samples ``idx`` [B] (device) on ``windows``."""
        return self._batch((ds.loc, ds.vel, ds.charges, ds.edge_weights),
                           {k: torch.as_tensor(v, device=self.device)
                            for k, v in windows.items()}, idx)

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

    def _shard(self, batch):
        loc_in, vel_in, charges, w, loc_out, t_in, t_out = batch
        cut = self.mesh.cut
        return (cut(loc_in, 0, 2), cut(vel_in, 0, 2), cut(charges, 0, 1),
                cut(w, 0, 1), cut(loc_out, 0, 2), cut(t_in, 0), cut(t_out, 0))

    def _forward(self, loc_in, vel_in, charges, w, t_in, t_out,
                 params=None):
        rows = self._rows(loc_in.shape[2])
        if self.model.num_inputs > 1:
            loc = loc_in.transpose(0, 1)                   # [L, B, N, 3]
            vel = vel_in.transpose(0, 1)
            nodes, edge_attr, loc_mean = prepare_inputs(
                loc, vel, w[None], charges[None], rows)
            return self._call(params, loc, vel, nodes, edge_attr, loc_mean,
                              timesteps_out=t_out, timesteps_in=t_in,
                              rows=rows)
        loc = loc_in[:, 0]
        vel = vel_in[:, 0]
        nodes, edge_attr, loc_mean = prepare_inputs(loc, vel, w, charges,
                                                    rows)
        return self._call(params, loc, vel, nodes, edge_attr, loc_mean,
                          timesteps_out=t_out, rows=rows)

    def _loss(self, batch, params=None):
        """(mean over timesteps, per-timestep losses [T]); the mean is the
        backprop target, the last timestep's loss the reported epoch loss
        (main_simulation_simple_no.py:287). ``params``: a name -> tensor
        dict to run the model on (None: its own parameters). Each frame's
        loss is the batch's squared error summed over the global count
        (the rank's share of the mean)."""
        loc_in, vel_in, charges, w, loc_out, t_in, t_out = batch
        t_model = self.model.num_timesteps
        params, (loc_in, vel_in, charges, w) = self._cast(
            params, (loc_in, vel_in, charges, w))
        x, _, _ = self._forward(loc_in, vel_in, charges, w, t_in,
                                t_out[:, :t_model], params)
        pred = x.to(torch.float32).transpose(0, 1)         # [B, T, N, 3]
        target = loc_out[:, :t_model]
        sq = (pred - target) ** 2
        count = sq[:, 0].numel() * self._shards()
        losses = sq.sum(dim=(0, 2, 3)) / count             # [T]
        return losses.mean(), losses

    @torch.no_grad()
    def rollout(self, batch, traj_len: int, dataset_kind: str):
        """Autoregressive windowed rollout (main_simulation_simple_no.py:342-384).

        Feeds the decoded frames at the input-offset positions back as the
        next window's inputs and evaluates the energy oracle per decoded
        frame. ``batch`` is global; with a mesh each rank rolls out its
        share and the frames are gathered. Returns (locs_pred
        [traj_len*T, B, N, 3], energies [traj_len*T, B, 1]).
        """
        loc, vel, charges, w, _, t_in, t_out_all = self.shard(batch)
        t_model = self.model.num_timesteps
        # feedback frames at timesteps_in - 1 (negative => from the end)
        fb = (t_in.to(torch.int64) - 1) % t_model          # [B, L]
        rows = torch.arange(fb.shape[0], device=fb.device)[:, None]
        xs, vs = [], []
        for i in range(traj_len):
            # per-window output timesteps, shifted back by i*T
            t_out = t_out_all[:, i * t_model:(i + 1) * t_model] - i * t_model
            x, v, _ = self._forward(loc, vel, charges, w, t_in, t_out)
            xs.append(x)
            vs.append(v)
            loc, vel = x[fb, rows], v[fb, rows]            # [B, L, N, 3]
        locs_pred = self._gathered(torch.cat(xs), 1, 2)
        vels = self._gathered(torch.cat(vs), 1, 2)
        energies = conserved_energy(dataset_kind, locs_pred, vels, batch[2])
        return locs_pred, energies[..., None]

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


class SEGNOExperiment(_Experiment):
    """SEGNO training, validation and evaluation (SEGNO/train_nbody.py
    semantics; counterpart of nonode_tpu/train/loop.py:SEGNOExperiment).

    Its windows are per batch: the input frames [NB, L], host integers,
    ascending, the last T frames before the target. With ``varDT`` and
    several inputs the segment lengths are drawn per batch, as the
    reference does (train_nbody.py:97-116); otherwise each is T // L. The
    JAX package's dynamic epochs mask ``max_interior`` steps past a traced
    segment length; here the lengths are host integers, so every epoch runs
    exactly each batch's segments: the same values."""

    def __init__(self, model: SEGNO, num_timesteps: int = 10,
                 varDT: bool = False, lr: float = 5e-3,
                 weight_decay: float = 1e-12,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(model, lr, weight_decay, compute_dtype)
        self.num_timesteps = num_timesteps
        self.varDT = varDT

    # ---------- input windows (train_nbody.py:97-114) ----------

    def sample_steps(self, ds: NBodyDataset, rng: np.random.RandomState,
                     num_batches: int) -> np.ndarray:
        """Input segment lengths [NB, L-1]: with ``varDT`` drawn in
        [1, max(T // L, 2)) per batch, else T // L and nothing drawn."""
        L, T = ds.num_inputs, self.num_timesteps
        if self.varDT and L > 1:
            return rng.randint(1, max(T // L, 2),
                               size=(num_batches, L - 1)).astype(np.int64)
        return np.full((num_batches, L - 1), T // L, np.int64)

    def max_interior(self, ds: NBodyDataset) -> int:
        """Upper bound on a varDT interior segment (drawn in [1, T//L))."""
        return max(self.num_timesteps // ds.num_inputs, 2)

    def frames_from_steps(self, ds: NBodyDataset, steps: np.ndarray):
        """Absolute input frames per batch [NB, L], ascending, ending at the
        dataset start; pushed to frame 0 when the window would start before
        the trajectory."""
        nb = steps.shape[0]
        cum = np.cumsum(np.concatenate([np.zeros((nb, 1), np.int64), steps],
                                       axis=1), axis=1)
        idxs = np.flip(ds.start - cum, axis=1)
        mins = idxs.min(axis=1, keepdims=True)
        idxs = np.where(mins < 0, idxs - mins, idxs)
        return np.ascontiguousarray(idxs).astype(np.int64)

    def windows(self, ds: NBodyDataset, rng: np.random.RandomState,
                num_batches: int) -> np.ndarray:
        """The input frames of each batch [NB, L]."""
        return self.frames_from_steps(ds, self.sample_steps(ds, rng,
                                                            num_batches))

    @staticmethod
    def _anchor(ds: NBodyDataset, frames) -> int:
        """The frame the model's input offsets and the rollout's targets
        count from: the dataset start, or the first input frame when the
        window was pushed forward (nonode_tpu/train/loop.py:641-650)."""
        return int(frames[0] if frames[-1] - frames[0] > ds.start
                   else frames[-1])

    # ---------- batches, forward, loss ----------

    def _features(self, loc, vel, charges, w, rows=None):
        """h = |v|; edge_attr = [q_i q_j, ||x_i - x_j||^2] from the LAST
        input frame's positions, held over the whole integration
        (train_nbody.py:115-123). ``rows``: the receivers' rows against
        the gathered senders."""
        speed = torch.sqrt((vel ** 2).sum(-1, keepdim=True))
        loc_last = loc[-1] if loc.dim() == 4 else loc
        senders = loc_last if rows is None else rows.gather(loc_last)
        diff = loc_last[..., :, None, :] - senders[..., None, :, :]
        dist = (diff ** 2).sum(-1, keepdim=True)
        return speed, torch.cat([w.expand(dist.shape), dist], dim=-1)

    def batch(self, ds: NBodyDataset, windows, b: int, idx):
        """Batch ``b`` of ``windows`` on samples ``idx`` [B] (device):
        (loc_in, vel_in, charges, w, loc_end, in_steps), the input frames
        [B, N, 3] (one input) or [L, B, N, 3], the target T frames after
        the last input frame, and the input offsets from the anchor (None
        for one input)."""
        frames = windows[b]
        loc, vel = ds.loc, ds.vel
        if len(frames) > 1:
            loc_in = torch.stack([loc[idx, int(f)] for f in frames])
            vel_in = torch.stack([vel[idx, int(f)] for f in frames])
            anchor = self._anchor(ds, frames)
            in_steps = tuple(int(f) - anchor for f in frames)
        else:
            loc_in, vel_in = loc[idx, int(frames[0])], vel[idx, int(frames[0])]
            in_steps = None
        end = int(frames[-1]) + self.num_timesteps
        return (loc_in, vel_in, ds.charges[idx], ds.edge_weights[idx],
                loc[idx, end], in_steps)

    def _shard(self, batch):
        loc_in, vel_in, charges, w, loc_end, in_steps = batch
        cut = self.mesh.cut
        b = loc_in.dim() - 3                   # [L, B, N, 3] or [B, N, 3]
        return (cut(loc_in, b, b + 1), cut(vel_in, b, b + 1),
                cut(charges, 0, 1), cut(w, 0, 1), cut(loc_end, 0, 1),
                in_steps)

    def _loss(self, batch, params=None):
        """(mean squared error of the position T steps ahead, the per-frame
        losses [1]: SEGNO predicts one frame). ``params`` as
        EGNOExperiment._loss; the squared error summed over the global
        count, as there."""
        loc_in, vel_in, charges, w, loc_end, in_steps = batch
        params, (loc_in, vel_in, charges, w) = self._cast(
            params, (loc_in, vel_in, charges, w))
        rows = self._rows(loc_end.shape[1])
        his, edge_attr = self._features(loc_in, vel_in, charges, w, rows)
        x, _, _ = self._call(params, his, loc_in, vel_in, edge_attr,
                             T=self.num_timesteps, in_steps=in_steps,
                             rows=rows)
        sq = (x.to(torch.float32) - loc_end) ** 2
        loss = sq.sum() / (sq.numel() * self._shards())
        return loss, loss[None]

    # ---------- rollout ----------

    @torch.no_grad()
    def rollout(self, batch, traj_len: int, dataset_kind: str):
        """Autoregressive rollout (train_nbody.py:200-236): each window's
        prediction is fed back; with several inputs the last L states slide,
        and the batch's ``in_steps`` shift by T a window until they reach
        their fixed point (-(L-1)T, ..., -T, 0). ``batch`` is global, as
        EGNOExperiment.rollout's. Returns (locs_pred [traj_len, B, N, 3],
        energies [traj_len, B, 1])."""
        loc, vel, charges, w, loc_end, in_steps = self.shard(batch)
        rows = self._rows(loc_end.shape[1])
        t = self.num_timesteps
        xs, vs = [], []
        for _ in range(traj_len):
            his, edge_attr = self._features(loc, vel, charges, w, rows)
            x, _, v = self.model(his, loc, vel, edge_attr, T=t,
                                 in_steps=in_steps, rows=rows)
            xs.append(x)
            vs.append(v)
            if in_steps:
                loc = torch.cat([loc[1:], x[None]])
                vel = torch.cat([vel[1:], v[None]])
                in_steps = tuple(s - t for s in (*in_steps[1:], t))
            else:
                loc, vel = x, v
        locs_pred = self._gathered(torch.stack(xs), 1, 2)
        vels = self._gathered(torch.stack(vs), 1, 2)
        energies = conserved_energy(dataset_kind, locs_pred, vels, batch[2])
        return locs_pred, energies[..., None]

    @torch.no_grad()
    def test_rollout(self, ds: NBodyDataset, batch_size: int,
                     rng: np.random.RandomState):
        """Full test evaluation over ``ds.traj_len`` windows. Returns
        (test_loss, avg_num_steps, artifact), artifact = {targets, preds,
        energy_conservation, test_loss} plus the finite-sample companions,
        as numpy arrays ([S, windows, N, 3])."""
        t = self.num_timesteps
        # one window count for every batch, sized for the worst-case start
        # any batch's sampled window could have (the reference truncates per
        # batch, train_nbody.py:137-138)
        L = ds.num_inputs
        max_start = ds.start if L <= 1 else max(
            ds.start, (L - 1) * (self.max_interior(ds) - 1))
        tl = max(min(ds.traj_len, (ds.n_frames - 1 - max_start) // t), 1)

        n = len(ds)
        tot_loss = tot_steps = count = 0.0
        targets_l, preds_l, energies_l = [], [], []
        for s0 in range(0, n - batch_size + 1, batch_size):   # drop_last
            # a window drawn per batch, as the reference's batch loop does
            frames = self.windows(ds, rng, 1)
            # targets anchor where the model's input offsets do
            # (train_nbody.py:104-107,136-137)
            pred_indices = self._anchor(ds, frames[0]) + np.cumsum([t] * tl)
            idx = torch.arange(s0, s0 + batch_size, device=ds.device)
            locs_pred, energies = self.rollout(
                self.batch(ds, frames, 0, idx), tl, ds.dataset)
            truth = torch.stack([ds.loc[idx, int(f)] for f in pred_indices])

            b = len(idx)
            _, avg_steps, _ = pearson_correlation_batch(
                locs_pred.reshape(tl, -1, 3), truth.reshape(tl, -1, 3),
                ds.n_balls)
            loss = ((locs_pred - truth) ** 2).mean(dim=(1, 2, 3)).mean()
            tot_loss += float(loss) * b
            tot_steps += float(avg_steps) * b
            count += b
            targets_l.append(truth.transpose(0, 1).cpu().numpy())
            preds_l.append(locs_pred.transpose(0, 1).cpu().numpy())
            energies_l.append(energies.transpose(0, 1).cpu().numpy())

        test_loss = tot_loss / count
        artifact = {
            "targets": np.concatenate(targets_l),
            "preds": np.concatenate(preds_l),
            "energy_conservation": np.concatenate(energies_l),
            "test_loss": test_loss,
        }
        artifact.update(_finite_metrics(artifact))
        return test_loss, tot_steps / count, artifact
