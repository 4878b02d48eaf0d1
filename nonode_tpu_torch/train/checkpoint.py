"""Save and load the port's own EGNO ``state_dict`` with torch.save.

The JAX package's flax-msgpack checkpoints are not read here: weights cross
frameworks only through compat.params.
"""

from __future__ import annotations

from pathlib import Path

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
