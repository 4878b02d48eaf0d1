"""Sweep orchestration: grid sweeps over the drivers (the port's counterpart
of nonode_tpu/parallel/sweep.py).

Parity with the reference's wandb sweep layer (_schedule.yaml:1-69 grids,
EGNO/sweep_params.py): named grid specs (method, metric, parameters with
value/values), cartesian expansion, and a runner that executes each config
through nonode_tpu_torch.main and collects the metric.

The runner executes configs one after another in one process on one card,
records per-run results to a JSONL ledger, and resumes by skipping configs
whose results already exist (a rerun would evaluate the checkpoint the
first run left at its save path). With ``--use_fleet`` each seed group
trains as one fleet (fleet_main, on #1/#2's seed axis); the remaining cells
(SEGNO multi-input/varDT) run through the sequential driver. A summary table
(mean ± std over seeds per group) reproduces the aggregation the reference
does in test.ipynb/plotting.

Usage:
    python -m nonode_tpu_torch.parallel.sweep --schedule grid.json --grid G \
        --data_dir data --outf results [--use_fleet] [--dry_run] \
        [--device cpu]

A schedule is JSON (``.json``) or YAML (any other suffix; needs ``yaml``,
which the card's machine does not have: write the grid as JSON there).
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

import numpy as np

from ..runtime import resolve_device

DEFAULT_SCHEDULE = {
    # The reference grids (_schedule.yaml): BASE sweeps model x dataset x
    # n_balls x 5 seeds; PRO adds multi-input and varDT over 3 seeds.
    "BASE": {
        "method": "grid",
        "metric": {"goal": "minimize", "name": "test_loss"},
        "parameters": {
            "exp_name": {"value": "_exp_new"},
            "dataset": {"values": ["charged", "gravity"]},
            "model": {"values": ["segno", "egno"]},
            "n_balls": {"values": [5, 10, 20]},
            "num_inputs": {"value": 1},
            "varDT": {"value": False},
            "seed": {"values": [1, 2, 3, 4, 5]},
        },
    },
    "PRO": {
        "method": "grid",
        "metric": {"goal": "minimize", "name": "test_loss"},
        "parameters": {
            "exp_name": {"value": "_exp_new"},
            "model": {"values": ["segno", "egno"]},
            "dataset": {"values": ["charged", "gravity"]},
            "n_balls": {"values": [5, 10]},
            "num_inputs": {"values": [2, 3]},
            "seed": {"values": [1, 2, 3]},
            "varDT": {"values": [True, False]},
        },
    },
}


def expand_grid(spec: dict) -> list[dict]:
    """Cartesian expansion of a wandb-style grid spec."""
    assert spec.get("method", "grid") == "grid"
    params = spec["parameters"]
    keys, value_lists = [], []
    for k, v in params.items():
        if "values" in v:
            keys.append(k)
            value_lists.append(list(v["values"]))
        elif "value" in v:
            keys.append(k)
            value_lists.append([v["value"]])
    return [dict(zip(keys, combo)) for combo in itertools.product(*value_lists)]


def config_id(cfg: dict) -> str:
    return "_".join(f"{k}={cfg[k]}" for k in sorted(cfg) if k != "exp_name")


def load_schedule(path: str | None, grid: str) -> dict:
    """Grid ``grid`` of the schedule file at ``path`` (JSON when it ends in
    ``.json``, else YAML); the built-in grid when there is no such file."""
    if path and Path(path).exists():
        with open(path) as f:
            if str(path).endswith(".json"):
                return json.load(f)[grid]
            import yaml
            return yaml.safe_load(f)[grid]
    return DEFAULT_SCHEDULE[grid]


def group_for_fleet(configs: list[dict]) -> dict:
    """Group fleet-able configs by everything-but-seed -> seed list. These
    groups train as one fleet program each. SEGNO: single-input non-varDT
    only (its multi-input/varDT cells run sequentially — no fleet win,
    RESULTS.md); EGNO: every PRO combination (fleet_main samples per-seed
    input offsets per epoch)."""
    groups = {}
    for cfg in configs:
        if cfg.get("model") not in ("egno", "segno"):
            continue
        if cfg.get("model") == "segno" and (cfg.get("num_inputs", 1) != 1
                                            or cfg.get("varDT", False)):
            continue
        key = json.dumps({k: v for k, v in cfg.items()
                          if k not in ("seed", "exp_name")}, sort_keys=True)
        groups.setdefault(key, []).append(cfg)
    return {k: v for k, v in groups.items() if len(v) > 1}


def run_sweep(grid_name: str, schedule_path: str | None, overrides: dict,
              ledger_path: Path, dry_run: bool = False,
              limit: int | None = None, use_fleet: bool = False) -> list[dict]:
    """Run every config in the grid; resume-safe via the JSONL ledger.

    ``overrides`` become driver flags of every run (the sequential driver
    takes them all; the fleet driver outf, data_dir, epochs, batch_size,
    max_samples, traj_len and device). With use_fleet=True, single-input
    seed groups (EGNO and SEGNO) train as one fleet program
    (parallel/fleet.py): K seeds for about one seed's wall-clock."""
    from ..main import get_args, main as run_main

    spec = load_schedule(schedule_path, grid_name)
    configs = expand_grid(spec)
    if limit is not None:
        configs = configs[:limit]
    metric_name = spec.get("metric", {}).get("name", "test_loss")

    done = {}
    ledger_path.parent.mkdir(parents=True, exist_ok=True)
    if ledger_path.exists():
        for line in ledger_path.read_text().splitlines():
            rec = json.loads(line)
            done[rec["config_id"]] = rec

    results = []

    if use_fleet and not dry_run:
        from ..fleet_main import get_args as fleet_args, main as fleet_run
        for key, group in group_for_fleet(configs).items():
            pending = [c for c in group if config_id(c) not in done]
            if not pending:
                continue
            base = pending[0]
            seeds = ",".join(str(c["seed"]) for c in pending)
            argv = ["--model", str(base["model"]),
                    "--dataset", str(base["dataset"]),
                    "--n_balls", str(base["n_balls"]),
                    "--seeds", seeds,
                    "--num_inputs", str(base.get("num_inputs", 1)),
                    "--varDT", str(base.get("varDT", False)),
                    "--exp_name", str(base.get("exp_name", "_exp_new")),
                    "--outf", str(overrides.get("outf", "results")),
                    "--data_dir", str(overrides.get("data_dir", "data"))]
            for k in ("epochs", "batch_size", "max_samples", "traj_len",
                      "device"):
                if k in overrides:
                    argv += [f"--{k}", str(overrides[k])]
            print(f"FLEET {base['model']}/{base['dataset']}/n={base['n_balls']} "
                  f"seeds [{seeds}]")
            t0 = time.time()
            records = fleet_run(fleet_args(argv))
            wall = round(time.time() - t0, 1)
            for cfg, rec in zip(pending, records):
                out = {"config_id": config_id(cfg), "config": cfg,
                       metric_name: rec["test_loss"],
                       "best_val_loss": rec["best_val_loss"],
                       "best_epoch": rec["best_epoch"],
                       "test_loss_finite": rec.get("test_loss_finite"),
                       "finite_fraction": rec.get("finite_fraction"),
                       "wall_s": wall, "fleet": True}
                with open(ledger_path, "a") as f:
                    f.write(json.dumps(out) + "\n")
                done[out["config_id"]] = out

    for i, cfg in enumerate(configs):
        cid = config_id(cfg)
        if cid in done:
            results.append(done[cid])
            continue
        if dry_run:
            print(f"[{i + 1}/{len(configs)}] DRY {cid}")
            continue
        print(f"[{i + 1}/{len(configs)}] RUN {cid}")
        argv = []
        merged = {**cfg, **overrides}
        for k, v in merged.items():
            argv += [f"--{k}", str(v)]
        args = get_args(argv)
        t0 = time.time()
        best_val_loss, test_loss, best_epoch = run_main(args)
        rec = {"config_id": cid, "config": cfg, metric_name: test_loss,
               "best_val_loss": best_val_loss, "best_epoch": best_epoch,
               "wall_s": round(time.time() - t0, 1)}
        with open(ledger_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        results.append(rec)
    return results


def summarize(results: list[dict], metric: str = "test_loss") -> dict:
    """Group by config minus seed; mean +- std over seeds (the aggregation
    plotting.py:400-429 / test.ipynb cell 16 perform on artifacts)."""
    groups = {}
    for rec in results:
        cfg = dict(rec["config"])
        cfg.pop("seed", None)
        cfg.pop("exp_name", None)
        key = json.dumps(cfg, sort_keys=True)
        groups.setdefault(key, []).append(rec[metric])
    return {k: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                "n_seeds": len(v)}
            for k, v in groups.items()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--schedule", type=str, default=None,
                        help="schedule file, JSON (.json) or YAML (defaults "
                             "to built-in grids)")
    parser.add_argument("--grid", type=str, default="BASE")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--outf", type=str, default="results")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--limit", type=int, default=None,
                        help="run only the first N grid configs")
    parser.add_argument("--use_fleet", action="store_true",
                        help="train seed groups as fleets")
    parser.add_argument("--traj_len", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="the device of every run (without CUDA the "
                             "sweep raises unless cpu is asked for)")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    overrides = {"data_dir": args.data_dir, "outf": args.outf,
                 "device": args.device}
    for k in ("epochs", "batch_size", "max_samples", "traj_len"):
        if getattr(args, k) is not None:
            overrides[k] = getattr(args, k)

    ledger = Path(args.outf) / f"sweep_{args.grid}.jsonl"
    results = run_sweep(args.grid, args.schedule, overrides, ledger,
                        dry_run=args.dry_run, limit=args.limit,
                        use_fleet=args.use_fleet)
    if results:
        summary = summarize(results)
        print(json.dumps(summary, indent=2))
        with open(Path(args.outf) / f"sweep_{args.grid}_summary.json", "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
