"""Device resolution, fp32 parity switches and seeding for every entry point."""

from __future__ import annotations

import random

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked for.

    Raises when CUDA is asked for (or defaulted to) and absent; it never
    moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    set_fp32_parity()
    return dev


def set_fp32_parity() -> None:
    """Full-fp32 products: the counterpart of ``Precision.HIGHEST`` in
    nonode_tpu/nn.py:43-48. TF32 keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python, NumPy and torch, and return a CPU generator for
    parameter initialisation."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
