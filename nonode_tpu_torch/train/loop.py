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

On the card a training step (the batch gather, the loss and its backward),
a validation step (the gather and the loss) and a rollout window (the
model's forward on the fed-back state) are each captured once as a CUDA
graph and replayed for every later one that bakes in the same inputs:
train/graphs.py's step runner, which the seed fleet shares, under
``_Experiment._key`` and ``_Experiment._roll_key``; each model's
``_window_key`` says what a step bakes in of its windows, and its
``rollout`` what a window bakes in of its host integers. Adam stays eager
after the replay, and so do the rollout's feedback, energies and metrics.
The CPU and a mesh run eagerly.

``_Experiment.test_rollout`` is the one test evaluation of both N-body
models: each gives its batches with their rollout length and truth frames,
and the predicted frames it keeps (``_rollout_draw``).

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
from ..utils.profiling import span
from .graphs import StepGraphs, data_layouts, layouts
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
    windows, what a graphed step bakes in of them (``_window_key``) and how
    it steps its forward stay behind them.

    ``mesh`` (parallel/mesh.py ``apply_mesh``): the batches are cut to the
    rank's share (``_shard``, per model) and the losses and gradients
    summed over the world.

    ``replays``: the steps (training and validation) that replayed a
    captured graph; ``rollout_replays``: the rollout windows that did."""

    def __init__(self, model, lr: float, weight_decay: float,
                 compute_dtype: torch.dtype | None = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.lr = lr
        self.weight_decay = weight_decay
        self.compute_dtype = compute_dtype
        self.mesh = None
        self._steps = StepGraphs()

    @property
    def replays(self) -> int:
        return self._steps.replays["train"] + self._steps.replays["eval"]

    @property
    def rollout_replays(self) -> int:
        return self._steps.replays["rollout"]

    @functools.cached_property
    def optimizer(self) -> torch.optim.Adam:
        """Adam with L2: wd * p joins the gradient before the moment updates
        (not AdamW), as nonode_tpu's optax.chain(add_decayed_weights, adam).
        Made at the first training step: the first Adam a process builds
        imports torch._dynamo, seconds of host time that an evaluation-only
        run does not need."""
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                weight_decay=self.weight_decay)

    def _backward(self, loss):
        with span("step.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()

    def _optimizer_step(self):
        with span("step.optimizer"):
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
        with span("step.forward"):
            loss, per_frame = self._loss(self.shard(batch))
        self._backward(loss)
        self._optimizer_step()
        return loss.detach(), per_frame.detach()

    def draw_epoch(self, ds: NBodyDataset, rng: np.random.RandomState,
                   batch_size: int, shuffle: bool = True):
        """(perm [NB, B], windows) of one epoch, drawn from ``rng`` in the
        JAX driver's order: the permutation, then the model's windows."""
        perm = make_perm(rng, len(ds), batch_size, shuffle)
        return perm, self.windows(ds, rng, len(perm))

    def _key(self, ds, windows, b, idx):
        """What a captured step of batch ``b`` bakes in (``StepGraphs.key``,
        with ``compute_dtype``). None where the step runs eagerly: off the
        card, and with a mesh (its gradient and loss sums stay eager)."""
        if self.mesh is not None:
            return None
        return self._steps.key((idx,), self.model.parameters(),
                               self._window_key(windows, b, idx),
                               self.compute_dtype, data_layouts(ds))

    def _roll_key(self, inputs, window):
        """What a captured rollout window on ``inputs`` bakes in
        (``StepGraphs.key``: their shapes, the parameters' storage, with
        ``compute_dtype``), ``window`` what its body bakes in besides. None
        where the window runs eagerly: off the card, on ``window`` None,
        and with a mesh (its gathers). A rollout takes it once: the
        shapes and the parameters hold over its windows."""
        if self.mesh is not None:
            return None
        return self._steps.key(inputs, self.model.parameters(), window,
                               self.compute_dtype)

    def _roll(self, body, inputs, key):
        """``body(*inputs)``, one fed-back window of a rollout: the step
        runner's ``rollout`` step under ``key`` (``_roll_key``), which on
        the card replays a graph of it with ``inputs`` copied in (span
        ``rollout.replay``); eager under None, the live graph left in
        place."""
        return self._steps.run("rollout", key, body, inputs, (),
                               replay="rollout.replay")

    def train_epoch(self, ds: NBodyDataset, windows, perm):
        """One Adam step per row of ``perm`` [NB, B] on ``windows``. Returns
        the per-batch (loss, reported loss: the last predicted frame's) as
        device tensors; nothing is synced to the host. With a mesh, both
        are summed over the world once, at the end."""
        losses, last = [], []
        for b, idx in enumerate(self._perm(perm)):

            def step(i, b=b):
                """The loss and its backward on the batch ``i``."""
                with span("step.batch"):
                    batch = self.batch(ds, windows, b, i)
                with span("step.forward"):
                    loss, per_frame = self._loss(self.shard(batch))
                self._backward(loss)
                return loss.detach(), per_frame[-1].detach()

            out = self._steps.run("train", self._key(ds, windows, b, idx),
                                  step, (idx,), (ds, windows),
                                  ("step.batch", "step.forward",
                                   "step.backward"))
            self._optimizer_step()
            losses.append(out[0])
            last.append(out[1])
        return self._summed(torch.stack(losses), torch.stack(last))

    @torch.no_grad()
    def eval_epoch(self, ds: NBodyDataset, windows, perm):
        """``train_epoch``'s per-batch losses without updates."""
        losses, last = [], []
        for b, idx in enumerate(self._perm(perm)):

            def step(i, b=b):
                """The loss on the batch ``i``."""
                with span("step.batch"):
                    batch = self.batch(ds, windows, b, i)
                loss, per_frame = self._loss(self.shard(batch))
                return loss, per_frame[-1]

            out = self._steps.run("eval", self._key(ds, windows, b, idx),
                                  step, (idx,), (ds, windows))
            losses.append(out[0])
            last.append(out[1])
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

    @torch.no_grad()
    def test_rollout(self, ds: NBodyDataset, batch_size: int,
                     rng: np.random.RandomState):
        """Full test evaluation: every full batch of ``ds`` (drop_last)
        rolled out and held against its truth frames. Returns (test_loss,
        avg_num_steps, artifact), artifact = {targets, preds,
        energy_conservation, test_loss} plus the finite-sample companions,
        as numpy arrays ([S, frames, N, 3]). The model draws the batches
        from ``rng`` and says how many predicted frames the loss and the
        artifact keep (``_rollout_draw``)."""
        draw, keep = self._rollout_draw(ds, rng)
        tot_loss = tot_steps = count = 0.0
        targets_l, preds_l, energies_l = [], [], []
        for s0 in range(0, len(ds) - batch_size + 1, batch_size):  # drop_last
            with span("rollout.batch"):
                idx = torch.arange(s0, s0 + batch_size, device=ds.device)
                batch, traj_len, truth = draw(idx)
            locs_pred, energies = self.rollout(batch, traj_len, ds.dataset)
            with span("rollout.metrics"):
                tcur = locs_pred.shape[0]
                truth = truth()[:tcur]                     # [T', B, N, 3]
                _, avg_steps, _ = pearson_correlation_batch(
                    locs_pred.reshape(tcur, -1, 3),
                    truth.reshape(tcur, -1, 3), truth.shape[2])
                loss = ((locs_pred[:keep] - truth[:keep]) ** 2).mean(
                    dim=(1, 2, 3)).mean()
            with span("rollout.readback"):
                tot_loss += float(loss) * batch_size
                tot_steps += float(avg_steps) * batch_size
                count += batch_size
                targets_l.append(truth.transpose(0, 1).cpu().numpy())
                preds_l.append(locs_pred[:keep].transpose(0, 1).cpu().numpy())
                energies_l.append(
                    energies[:keep].transpose(0, 1).cpu().numpy())

        test_loss = tot_loss / count
        artifact = {
            "targets": np.concatenate(targets_l),
            "preds": np.concatenate(preds_l),
            "energy_conservation": np.concatenate(energies_l),
            "test_loss": test_loss,
        }
        artifact.update(_finite_metrics(artifact))
        return test_loss, tot_steps / count, artifact


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

    def _window_key(self, windows, b: int, idx):
        """What a graphed step of batch ``b`` bakes in of ``windows``
        (train/graphs.py ``StepGraphs.key``): the storage of the per-sample
        index tensors; None (eager) where one is not a tensor on ``idx``'s
        device."""
        if all(isinstance(t, torch.Tensor) and t.device == idx.device
               for t in windows.values()):
            return layouts(windows.values())
        return None

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
                 params=None, key=None):
        """(x, v, h) [T, B, N, .], the frames the model decodes from a
        batch's inputs, on ``params`` (None: its own). ``key``: a rollout
        window's (``_Experiment._roll_key``), under which the step runner
        replays a graph of the frames; its x and v are fresh tensors, its
        h None."""
        if key is not None:
            x, v = self._roll(self._rolled_frames, (
                loc_in, vel_in, charges, w, t_in, t_out), key)
            return x, v, None
        return self._frames(loc_in, vel_in, charges, w, t_in, t_out, params)

    def _rolled_frames(self, *inputs):
        """A rollout window's body: x and v of ``_frames``."""
        return self._frames(*inputs)[:2]

    def _frames(self, loc_in, vel_in, charges, w, t_in, t_out, params=None):
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
        key = self._roll_key((loc, vel, charges, w, t_in,
                              t_out_all[:, :t_model]), ())
        xs, vs = [], []
        for i in range(traj_len):
            with span("rollout.window"):
                # per-window output timesteps, shifted back by i*T
                t_out = (t_out_all[:, i * t_model:(i + 1) * t_model]
                         - i * t_model)
                x, v, _ = self._forward(loc, vel, charges, w, t_in, t_out,
                                        key=key)
                xs.append(x)
                vs.append(v)
                loc, vel = x[fb, rows], v[fb, rows]        # [B, L, N, 3]
        with span("rollout.energy"):
            locs_pred = self._gathered(torch.cat(xs), 1, 2)
            vels = self._gathered(torch.cat(vs), 1, 2)
            energies = conserved_energy(dataset_kind, locs_pred, vels,
                                        batch[2])
        return locs_pred, energies[..., None]

    def _rollout_draw(self, ds: NBodyDataset, rng: np.random.RandomState):
        """``test_rollout``'s batches and the frames it keeps: the index
        arrays drawn once for the call, a batch of samples ``idx`` on them
        -> (the batch, its rollout length, its truth frames: the batch's
        targets), and the first 0.4 x traj_len x T predicted frames."""
        with span("rollout.batch"):                   # the call's indices
            idx_np = self.epoch_index_arrays(ds, rng)
            idx_arrays = {k: torch.from_numpy(v).to(ds.device)
                          for k, v in idx_np.items()}
        traj_len = min(ds.traj_len, idx_np["out_frames"].shape[1]
                       // self.model.num_timesteps)
        ds_arrays = (ds.loc, ds.vel, ds.charges, ds.edge_weights)

        def draw(idx):
            batch = self._batch(ds_arrays, idx_arrays, idx)
            return batch, traj_len, lambda: batch[4].transpose(0, 1)

        return draw, int(0.4 * ds.traj_len * self.model.num_timesteps)


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

    def _window_key(self, windows, b: int, idx):
        """Batch ``b``'s input frames, host integers."""
        return tuple(int(f) for f in windows[b])

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

        def window(loc, vel, charges, w):
            """A window's (x, v), at the window's ``in_steps``."""
            his, edge_attr = self._features(loc, vel, charges, w, rows)
            x, _, v = self.model(his, loc, vel, edge_attr, T=t,
                                 in_steps=in_steps, rows=rows)
            return x, v

        key = None               # the windows' at the in_steps' fixed point
        xs, vs = [], []
        for _ in range(traj_len):
            with span("rollout.window"):
                shifted = in_steps and tuple(
                    s - t for s in (*in_steps[1:], t))
                fixed = shifted == in_steps
                inputs = (loc, vel, charges, w)
                if fixed and key is None:
                    key = self._roll_key(inputs, (t, in_steps))
                # windows before the fixed point run eagerly
                x, v = self._roll(window, inputs, key if fixed else None)
                xs.append(x)
                vs.append(v)
                if in_steps:
                    loc = torch.cat([loc[1:], x[None]])
                    vel = torch.cat([vel[1:], v[None]])
                    in_steps = shifted
                else:
                    loc, vel = x, v
        with span("rollout.energy"):
            locs_pred = self._gathered(torch.stack(xs), 1, 2)
            vels = self._gathered(torch.stack(vs), 1, 2)
            energies = conserved_energy(dataset_kind, locs_pred, vels,
                                        batch[2])
        return locs_pred, energies[..., None]

    def _rollout_draw(self, ds: NBodyDataset, rng: np.random.RandomState):
        """``test_rollout``'s batches and the frames it keeps: a batch of
        samples ``idx`` -> (the batch on a window drawn from ``rng`` for
        it, as the reference's batch loop draws one, its rollout length,
        its truth frames: the frame T, 2T, ... after the anchor, where the
        model's input offsets count from, train_nbody.py:104-107,136-137),
        and every predicted frame (None)."""
        t = self.num_timesteps
        # one window count for every batch, sized for the worst-case start
        # any batch's sampled window could have (the reference truncates per
        # batch, train_nbody.py:137-138)
        L = ds.num_inputs
        max_start = ds.start if L <= 1 else max(
            ds.start, (L - 1) * (self.max_interior(ds) - 1))
        tl = max(min(ds.traj_len, (ds.n_frames - 1 - max_start) // t), 1)

        def draw(idx):
            frames = self.windows(ds, rng, 1)
            pred_indices = self._anchor(ds, frames[0]) + np.cumsum([t] * tl)
            return (self.batch(ds, frames, 0, idx), tl,
                    lambda: torch.stack([ds.loc[idx, int(f)]
                                         for f in pred_indices]))

        return draw, None
