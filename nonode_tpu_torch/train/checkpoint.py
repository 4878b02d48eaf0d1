"""Save and load the port's own EGNO ``state_dict`` with torch.save, and
early stopping (counterpart of nonode_tpu/train/checkpoint.py).

The JAX package's flax-msgpack checkpoints are not read here: weights cross
frameworks only through compat.params.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn


def save_params(path, module: nn.Module):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               path)


def load_params(path, module: nn.Module) -> nn.Module:
    """Load ``path`` into ``module`` (strict: every name must match)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state, strict=True)
    return module


class EarlyStopping:
    """The reference EarlyStopping (EGNO/utils.py:229-278): save the model on
    every val-loss improvement by more than ``delta``, stop after
    ``patience`` evaluations without one."""

    def __init__(self, patience=7, verbose=False, delta=0.0,
                 path="checkpoint.ckpt", trace_func=print):
        self.patience = patience
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = np.inf
        self.delta = delta
        self.path = path
        self.trace_func = trace_func

    def __call__(self, val_loss, module: nn.Module):
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            self.save_checkpoint(val_loss, module)
        elif score < self.best_score + self.delta:
            self.counter += 1
            self.trace_func(
                f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.save_checkpoint(val_loss, module)
            self.counter = 0

    def save_checkpoint(self, val_loss, module: nn.Module):
        if self.verbose:
            self.trace_func(
                f"Validation loss decreased ({self.val_loss_min:.6f} --> "
                f"{val_loss:.6f}).  Saving model ...")
        save_params(self.path, module)
        self.val_loss_min = val_loss
