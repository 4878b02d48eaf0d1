"""EGNO model config: the reference model_confs.yaml defaults, with optional
YAML overrides (counterpart of nonode_tpu/config.py:18-31).

``yaml`` is imported only when a config path is given, so the defaults need
nothing beyond the standard library.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class EGNOConfig:
    num_timesteps: int = 10
    n_layers: int = 4
    hidden_nf: int = 64
    flat: bool = False
    norm: bool = False
    time_emb_dim: int = 32
    in_node_nf: int = 2
    in_edge_nf: int = 2
    with_v: bool = True
    num_modes: int = 2
    lr: float = 1e-4
    weight_decay: float = 1e-8


def load_model_config(model: str, config_path: str | Path | None = None):
    """The EGNO config; ``config_path`` (a model_confs.yaml-schema file)
    overrides the defaults, None means the defaults."""
    if model != "egno":
        raise NotImplementedError(
            f"model {model!r}: only EGNO is ported; SEGNO comes with "
            "ROADMAP.md Queue 1 'SEGNO slice'")
    cfg = EGNOConfig()
    if config_path is None:
        return cfg
    import yaml

    with open(config_path) as f:
        raw = yaml.safe_load(f)["EGNO"]
    fields = {f.name for f in dataclasses.fields(EGNOConfig)}
    updates = {}
    if "num_timesteps" in raw:
        updates["num_timesteps"] = raw["num_timesteps"]
    for k, v in raw.get("model_params", {}).items():
        if k in fields:
            updates[k] = v
    tp = raw.get("training_params", {})
    for k in ("lr", "weight_decay"):
        if k in tp:
            updates[k] = float(tp[k])
    return dataclasses.replace(cfg, **updates)
