"""EGNO model config: the reference model_confs.yaml defaults, with optional
YAML overrides (counterpart of nonode_tpu/config.py:18-31), and the JSON
presets of ``--config_by_file`` (nonode_tpu/main.py:87-134).

``yaml`` is imported only when a config path is given, so the defaults need
nothing beyond the standard library.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

# the bare --config_by_file flag loads this preset, the port's copy of
# nonode_tpu/configs/config_simulation_simple_no.json
DEFAULT_PRESET = Path(__file__).parent / "configs" / \
    "config_simulation_simple_no.json"
# preset key -> model-config field (the reference driver's --lr/--nf/...)
PRESET_CFG_KEYS = (("lr", "lr"), ("weight_decay", "weight_decay"),
                   ("n_layers", "n_layers"), ("nf", "hidden_nf"),
                   ("time_emb_dim", "time_emb_dim"),
                   ("num_modes", "num_modes"))


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


def apply_preset(args, path: str | Path | None = None) -> dict:
    """Merge a JSON preset over the parsed ``args`` in place, as the
    reference standalone driver does (main_simulation_simple_no.py:389-399):
    only keys the namespace already has; ``max_training_samples`` becomes
    ``max_samples``. Returns the preset's model hyperparameters under their
    model-config names, for ``overlay``."""
    with open(path or DEFAULT_PRESET) as f:
        preset = json.load(f)
    for k, v in preset.items():
        if hasattr(args, k):
            setattr(args, k, v)
    if "max_training_samples" in preset:
        args.max_samples = preset["max_training_samples"]
    args.outf = Path(args.outf)
    args.data_dir = Path(args.data_dir)
    return {dst: preset[src] for src, dst in PRESET_CFG_KEYS if src in preset}


def overlay(cfg: EGNOConfig, overrides: dict) -> EGNOConfig:
    """The preset's hyperparameters over the model config (lr and
    weight_decay as floats)."""
    return dataclasses.replace(cfg, **{
        k: (float(v) if k in ("lr", "weight_decay") else v)
        for k, v in overrides.items()})
