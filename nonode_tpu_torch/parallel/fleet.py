"""Seed fleets: K independently seeded replicas of one experiment trained as
one program (counterpart of nonode_tpu/parallel/fleet.py).

The JAX package vmaps a whole epoch over replicas so that K seeds share one
dispatch. Here every training step vmaps the experiment's own loss
(``torch.func.vmap`` over ``functional_call`` of the ordinary modules) over
parameters stacked along a leading seed axis [K, ...]: each op of the step
is launched once for all K seeds, and the pairwise chain's kernels #1/#2
take the K weight sets in one launch each (their vmap rule,
ops/kernels/egnn_fused.py). Each replica consumes its own batch
permutation; evaluation batches are shared.

On the card a step's vmapped loss (in training with its backward) is
captured once as a CUDA graph and replayed for every later step that bakes
in the same inputs: train/graphs.py's step runner, which the per-seed loop
shares, under ``SeedFleet._key``, which asks the template experiment what
a step bakes in of its windows. Everything else, the CPU and fleets with
per-seed windows included, runs eagerly.

Also here: the padding-free strided evaluation split of the reference's
DistributedEvalSampler (SEGNO/utils.py:46-93), and early stopping over K
seeds with the decisions of K sequential EarlyStopping instances.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..runtime import seed_everything
from ..train.graphs import StepGraphs, data_layouts
from ..train.loop import make_perm, zero_missing_grads
from ..utils.profiling import span


def eval_shard_indices(n: int, world_size: int, rank: int,
                       shuffle: bool = False, seed: int = 0,
                       epoch: int = 0) -> np.ndarray:
    """Strided, padding-free eval split (DistributedEvalSampler semantics)."""
    if shuffle:
        rng = np.random.RandomState(seed + epoch)
        indices = rng.permutation(n)
    else:
        indices = np.arange(n)
    return indices[rank:n:world_size]


class FleetEarlyStopping:
    """Early stopping over K seeds, decision-equivalent to K sequential
    ``train.checkpoint.EarlyStopping`` instances (the same strict
    improvement rule and patience counting)."""

    def __init__(self, k: int, patience: int = 15, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.best_val = np.full(k, np.inf)
        self.best_epoch = np.zeros(k, int)
        self.counter = np.zeros(k, int)
        self.stopped = np.zeros(k, bool)

    def __call__(self, val: np.ndarray, epoch: int) -> np.ndarray:
        """val: [K] validation losses (entries for stopped seeds ignored).
        Returns the improved mask [K]."""
        # Ties count as improvement (the reference EarlyStopping counts only
        # when score < best + delta). In this negated form a NaN val fails
        # `score < best + delta` too and lands in the improvement branch
        # (best := NaN, checkpoint kept, counter reset), and every later val
        # compares False against the NaN best, so it also "improves":
        # `val <= best - delta` would count NaNs toward patience and stop,
        # unlike the sequential runs.
        improved = ~(val > self.best_val - self.delta) & ~self.stopped
        self.best_val = np.where(improved, val, self.best_val)
        self.best_epoch = np.where(improved, epoch, self.best_epoch)
        self.counter = np.where(improved, 0,
                                np.where(self.stopped, self.counter,
                                         self.counter + 1))
        self.stopped |= self.counter >= self.patience
        return improved

    @property
    def all_stopped(self) -> bool:
        return bool(self.stopped.all())


class SeedFleet:
    """Train K independently seeded replicas of an EGNO or SEGNO experiment
    at once. ``exp`` is the experiment of one replica: its model is the
    template that every step runs on the stacked parameters (a name ->
    [K, ...] tensor dict), and its loss, batches and windows are the
    sequential driver's. ``remat``: recompute the loss's forward in the
    backward instead of keeping its activations (nonode_tpu's
    ``jax.checkpoint`` of the EGNO forward). torch.utils.checkpoint does not
    compose inside vmap, so the fleet checkpoints the vmapped loss as a
    whole: the same recomputation.

    ``replays``: the steps (training and validation) that replayed a
    captured graph."""

    def __init__(self, exp, seeds, remat: bool = False):
        self.exp = exp
        self.seeds = list(seeds)
        self.remat = remat
        self._steps = StepGraphs()

    @property
    def replays(self) -> int:
        return sum(self._steps.replays.values())

    @property
    def k(self) -> int:
        return len(self.seeds)

    def init(self, build):
        """(params, optimizer): seed s's parameters are those of
        ``build(seed_everything(s))``, the model the sequential driver
        builds at ``--seed s``, stacked over the seed axis."""
        models = [build(seed_everything(s)) for s in self.seeds]
        params = {name: torch.stack([dict(m.named_parameters())[name]
                                     .detach() for m in models])
                  .requires_grad_()
                  for name, _ in models[0].named_parameters()}
        return params, self.optimizer(params)

    def optimizer(self, params) -> torch.optim.Adam:
        """Adam-L2 over the stacked leaves. It is K independent Adam-L2s
        only because the fleet's loss is the SUM of the per-seed losses:
        then seed s's slice of a leaf's gradient is its own loss's gradient,
        and Adam's update (weight decay included) is elementwise. A mean
        would scale each seed's gradient by 1/K, which Adam's eps and the
        weight decay do not absorb."""
        return torch.optim.Adam(list(params.values()), lr=self.exp.lr,
                                weight_decay=self.exp.weight_decay)

    def make_perms(self, rngs, n, batch_size):
        """Per-seed epoch permutations: [K, num_batches, B]."""
        return np.stack([make_perm(r, n, batch_size) for r in rngs])

    def _losses(self, params, ds, windows, b, idx, per_seed_windows):
        """(loss [K], per-frame losses [K, T']) of batch ``b``: the
        experiment's ``_loss`` vmapped over the seed axis of ``params``,
        ``idx`` ([K, B], or [B] shared) and, with ``per_seed_windows``, of
        every tensor in ``windows``."""
        exp = self.exp

        def one(p, i, w):
            return exp._loss(exp.batch(ds, w if per_seed_windows else windows,
                                       b, i), p)

        w_in = windows if per_seed_windows else None
        fn = torch.func.vmap(one, in_dims=(0, 0 if idx.dim() == 2 else None,
                                           0 if per_seed_windows else None))
        if self.remat and torch.is_grad_enabled():
            # the loss draws no random numbers: no generator state to keep
            # for the recomputation (and none can be set inside a capture)
            return checkpoint(fn, params, idx, w_in, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(params, idx, w_in)

    def _key(self, params, ds, windows, b, idx, per_seed_windows):
        """What a captured step of batch ``b`` bakes in (``StepGraphs.key``,
        with ``remat``); K and B are in the index shape and the
        parameters'. None where the step runs eagerly: off the card, or
        with per-seed windows (drawn anew every epoch)."""
        if per_seed_windows:
            return None
        return self._steps.key((idx,), params.values(),
                               self.exp._window_key(windows, b, idx),
                               self.remat, data_layouts(ds))

    def train_epoch(self, params, opt, ds, windows, perms,
                    per_seed_windows=False):
        """One Adam-L2 step of every seed per batch: ``perms`` [K, NB, B];
        ``windows`` the experiment's (shared), or stacked per seed. Updates
        ``params`` in place; returns the per-batch (loss, reported loss)
        [K, NB] as device tensors."""
        perms = torch.from_numpy(np.asarray(perms, np.int64)).to(
            self.exp.device)
        losses, last = [], []
        for b in range(perms.shape[1]):
            idx = perms[:, b]

            def step(i, b=b):
                """The loss and its backward on the batch ``i``."""
                with span("step.forward"):
                    loss, per_frame = self._losses(params, ds, windows, b, i,
                                                   per_seed_windows)
                with span("step.backward"):
                    opt.zero_grad(set_to_none=True)
                    loss.sum().backward()    # the sum: see ``optimizer``
                return loss.detach(), per_frame[:, -1].detach()

            out = self._steps.run("train", self._key(
                params, ds, windows, b, idx, per_seed_windows), step, (idx,),
                (params, ds, windows), ("step.forward", "step.backward"))
            with span("step.optimizer"):
                zero_missing_grads(params.values())
                opt.step()
            losses.append(out[0])
            last.append(out[1])
        return torch.stack(losses, 1), torch.stack(last, 1)

    @torch.no_grad()
    def eval_epoch(self, params, ds, windows, perm, per_seed_windows=False):
        """``train_epoch``'s per-batch losses [K, NB] without updates, on
        the batches of ``perm`` [NB, B], shared by every seed."""
        perm = torch.from_numpy(np.asarray(perm, np.int64)).to(
            self.exp.device)
        losses, last = [], []
        for b in range(perm.shape[0]):
            idx = perm[b]

            def step(i, b=b):
                """The loss on the batch ``i``."""
                loss, per_frame = self._losses(params, ds, windows, b, i,
                                               per_seed_windows)
                return loss, per_frame[:, -1]

            out = self._steps.run("eval", self._key(
                params, ds, windows, b, idx, per_seed_windows), step, (idx,),
                (params, ds, windows))
            losses.append(out[0])
            last.append(out[1])
        return torch.stack(losses, 1), torch.stack(last, 1)

    def split(self, params):
        """Stacked params -> one ``state_dict`` per seed."""
        k = next(iter(params.values())).shape[0]
        return [{name: p[i].detach() for name, p in params.items()}
                for i in range(k)]

    def take(self, params, opt, keep):
        """Fleet compaction: the rows ``keep`` of the parameters and of
        Adam's state (exp_avg, exp_avg_sq; the shared step count), so that
        stopped seeds stop consuming compute. Returns (params, optimizer)."""
        keep = torch.as_tensor(np.asarray(keep), dtype=torch.int64,
                               device=self.exp.device)
        new = {name: p.detach()[keep].clone().requires_grad_()
               for name, p in params.items()}
        new_opt = self.optimizer(new)
        for old_p, new_p in zip(params.values(), new.values()):
            state = opt.state.get(old_p)
            if state:
                new_opt.state[new_p] = {
                    key: (v.clone() if key == "step" else v[keep].clone())
                    for key, v in state.items()}
        return new, new_opt
