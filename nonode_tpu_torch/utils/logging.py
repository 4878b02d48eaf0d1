"""Run logging with a local JSONL backend, mirrored to wandb when ``use_wb``
is set (the port's copy of nonode_tpu/utils/logging.py:RunLogger). wandb is
imported only when asked for."""

from __future__ import annotations

import json
import time
from pathlib import Path


class RunLogger:
    def __init__(self, out_dir, name: str, config: dict | None = None,
                 use_wandb: bool = False, project: str = "Particle-Physics"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.path = self.out_dir / f"{name}_metrics.jsonl"
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("wandb not installed; logging locally only")
            else:
                self._wandb = wandb
                wandb.init(project=project, config=config or {}, name=name)
        if config is not None:
            with open(self.out_dir / f"{name}_config.json", "w") as f:
                json.dump({k: str(v) for k, v in config.items()}, f, indent=2)

    def log(self, metrics: dict, step: int | None = None):
        rec = {"time": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_artifact(self, file_path, name: str | None = None,
                     type_: str = "results"):
        """Record an artifact pointer (and upload when wandb is live)."""
        rec = {"artifact": str(file_path), "name": name or Path(file_path).stem,
               "type": type_}
        with open(self.out_dir / f"{self.name}_artifacts.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            art = self._wandb.Artifact(name=rec["name"].replace("=", "-"),
                                       type=type_)
            art.add_file(local_path=str(file_path))
            art.save()

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
