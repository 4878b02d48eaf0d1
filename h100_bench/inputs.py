"""What every cell builds from its configuration and seed before the
program runs: the charged splits (simulated on the device and saved where
the program's data loader reads them), the weights (drawn on the device
from the reference's init bounds, in one call), the numpy streams of the
program's host-side draws, and the program's own arguments."""

from __future__ import annotations

import dataclasses
import importlib
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import splits

# numpy streams and torch generators are keyed by (seed, stream, ...); the
# streams of one run never share a key
DATA, WEIGHTS, HOST = 0, 1, 2
EVAL, FLEET_SEED, TEST = 0, 1, 2         # the host streams


@dataclasses.dataclass
class Context:
    """A cell's run: its configuration (the file's keys; ``path`` the
    file), its mix's parameters, the seed, the device, the reference and
    the counts of its model (``reference/<model>.py``,
    ``counts/<model>.py``)."""

    name: str
    cfg: dict
    cfg_path: Path
    params: dict
    seed: int
    device: torch.device
    phases: dict = dataclasses.field(default_factory=dict)
    last: float = 0.0

    def mark(self, phase, since=None):
        """Record the seconds since the last mark (or ``since``) as
        ``phase`` of the set-up."""
        now = time.perf_counter()
        self.phases[phase] = now - (self.last if since is None else since)
        self.last = now

    @property
    def model(self) -> str:
        return self.cfg["model"]

    @property
    def reference(self):
        return importlib.import_module(f"h100_bench.reference.{self.model}")

    @property
    def counts(self):
        return importlib.import_module(f"h100_bench.counts.{self.model}")


def generator(ctx: Context, stream: int) -> torch.Generator:
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(np.random.SeedSequence([ctx.seed, stream])
                      .generate_state(1, np.uint64)[0]) >> 1)
    return g


def host_rng(ctx: Context, *key: int) -> np.random.RandomState:
    """A numpy stream of the run's, one for each ``key`` (EVAL, TEST,
    FLEET_SEED and the seed's index)."""
    return np.random.RandomState(np.random.SeedSequence(
        [ctx.seed, HOST, *key]).generate_state(4))


def make_splits(ctx: Context, names):
    """Simulate the splits ``names`` on the device and save them in a
    temporary directory in the program's file layout. Returns (the
    directory, {split: (loc, vel, charges) as [S, F, N, 3] host arrays})
    for the reference; the caller removes the directory."""
    cfg = dict(ctx.cfg)
    for s in splits.SPLITS:
        if s not in names:
            cfg[f"num_{s}"] = 0
    sim = splits.simulate(cfg, generator(ctx, DATA), ctx.device)
    sim = {k: v for k, v in sim.items() if k in names}
    tmp = tempfile.TemporaryDirectory(prefix="h100_bench_")
    host = splits.write(sim, cfg, tmp.name)
    ctx.mark("data")
    return tmp, host


def make_weights(ctx: Context, k: int):
    """K weight sets {name: [K, ...]} on the device."""
    weights = ctx.reference.draw_weights(ctx.cfg, k,
                                         generator(ctx, WEIGHTS), ctx.device)
    ctx.mark("weights")
    return weights


def program_args(ctx: Context, data_dir):
    """The program's argument namespace for this configuration: its model,
    the device, the data directory and the configuration file as the
    program's ``--config_by_file`` preset (widths, lr, batch, windows).
    Raises when a width the program takes from its built-in config
    differs from the file's."""
    from nonode_tpu_torch.config import load_model_config, overlay
    from nonode_tpu_torch.main import get_args

    args = get_args(["--model", ctx.model, "--device", ctx.device.type,
                     "--data_dir", str(data_dir), "--config_by_file",
                     str(ctx.cfg_path)])
    built = overlay(load_model_config(ctx.model), args._cfg_overrides)
    for field, value in dataclasses.asdict(built).items():
        want = ctx.cfg.get("nf" if field == "hidden_nf" else field)
        if want is not None and want != value:
            raise ValueError(f"{ctx.name}: the program runs {field}={value}, "
                             f"the configuration states {want}")
    return args
