"""Results registry: the experiment index layer (the port's copy of
nonode_tpu/analysis/registry.py).

Parity with artifact_model_map_complete.json + the aggregation cells of
test.ipynb: scan a results directory for run artifacts, group them by
configuration (model, dataset, n_balls, num_inputs, varDT, num_timesteps)
with seeds collected per group, and emit aggregated reports. It reads files
on the host and takes no device.

Run as a CLI:
    python -m nonode_tpu_torch.analysis.registry --results results --out report
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import re
from pathlib import Path

FNAME_RE = re.compile(
    r"(?P<model>EGNO|SEGNO)_(?P<dataset>\w+?)_seed=(?P<seed>\d+)"
    r"_n_part=(?P<n_balls>\d+)_n_inputs=(?P<num_inputs>\d+)"
    r"_dT_(?P<dT>\d+)_varDT=(?P<varDT>\w+)"
    r"_num_timesteps=(?P<num_timesteps>\d+)_results\.(?P<fmt>npz|pt)$")

# the group key's source framework by artifact format: the drivers write
# ``.npz`` (as nonode_tpu's), the reference torch pickles
SRC_NAME = {"npz": "jax", "pt": "torch"}


def artifact_stem(model, dataset, seed, n_balls, num_inputs=1, dT=1,
                  varDT=False, num_timesteps=10):
    """Canonical artifact/checkpoint stem, as main.py and fleet_main.py write
    it; append ``_results.npz`` for the trajectory artifact. Always matches
    FNAME_RE with ``_results.npz|pt`` appended."""
    return (f"{model.upper()}_{dataset}_seed={seed}_n_part={n_balls}"
            f"_n_inputs={num_inputs}_dT_{dT}_varDT={varDT}"
            f"_num_timesteps={num_timesteps}")


def scan_results(results_dir, exclude=("transplant*",)) -> dict:
    """Build {group_key: {seed: artifact_path}} from a results tree.

    Indexes BOTH artifact formats — the drivers' ``*_results.npz`` and
    reference torch ``*_results.pt`` pickles (main.py:188-191) — so a mixed
    tree aggregates cross-framework. The source framework becomes part of
    the group key (``src=torch|jax``): same-config groups from the two
    frameworks stay separate seed bands, exactly what the reference's
    cross-run comparison figures plot (plotting.py:981-1116).

    Skips any artifact under a directory matching one of ``exclude``
    (fnmatch patterns): auxiliary trees like ``transplant*`` dirs hold
    cross-framework weight-transplant rollouts whose filenames are
    indistinguishable from native runs and would silently overwrite
    same-seed native entries."""
    registry = {}
    for path in sorted(Path(results_dir).rglob("*_results.*")):
        parts = path.relative_to(results_dir).parts[:-1]
        if any(fnmatch.fnmatch(p, pat) for p in parts for pat in exclude):
            continue
        m = FNAME_RE.match(path.name)
        if not m:
            continue
        cfg = m.groupdict()
        seed = cfg.pop("seed")
        cfg["src"] = SRC_NAME[cfg.pop("fmt")]
        key = "_".join(f"{k}={cfg[k]}" for k in sorted(cfg))
        registry.setdefault(key, {})[seed] = str(path)
    return registry


def build_report(results_dir, out_dir=None, exclude=("transplant*",)):
    """Aggregate every seed group: mean/std curves, test losses, LaTeX table,
    and (where matplotlib is installed) figures."""
    from .results import analyze_group, latex_table, plot_multiple_curves

    registry = scan_results(results_dir, exclude=exclude)
    report = {}
    rows = []
    curves = {}
    for key, seeds in registry.items():
        agg = analyze_group(list(seeds.values()))
        report[key] = {
            "seeds": sorted(seeds),
            "test_loss_mean": agg["test_loss_mean"],
            "test_loss_std": agg["test_loss_std"],
            "mse_mean": agg["mse_mean"].tolist(),
            "mse_std": agg["mse_std"].tolist(),
            "corr_mean": agg["corr_mean"].tolist(),
            # absent for energy-free artifacts (motion: the reference stores
            # energy_conservation=None there, main_simulation_simple_no.py:380)
            **({"energy_drift_mean": agg["energy_drift_mean"].tolist()}
               if "energy_drift_mean" in agg else {}),
        }
        rows.append((key.replace("_", " "), agg["test_loss_mean"],
                     agg["test_loss_std"]))
        curves[key] = (agg["mse_mean"], agg["mse_std"])

    if len(curves) > 1:
        # legend labels: only the fields that differ across groups. Fields
        # are re-parsed from an artifact FILENAME (FNAME_RE), not from the
        # underscore-joined group key — values may themselves contain
        # underscores (e.g. dataset 'charged_a'), which a key split would
        # truncate and collapse distinct groups into one label.
        fields = sorted(set(FNAME_RE.groupindex) - {"seed", "fmt"} | {"src"})
        parts = []
        for key in curves:
            name = Path(next(iter(registry[key].values()))).name
            cfg = FNAME_RE.match(name).groupdict()
            cfg["src"] = SRC_NAME[cfg.pop("fmt")]
            cfg.pop("seed")
            parts.append(cfg)
        varying = [f for f in fields
                   if len({p.get(f) for p in parts}) > 1]
        curves = {" ".join(f"{f}={p[f]}" for f in varying): v
                  for p, v in zip(parts, curves.values())}

    out = {"registry": registry, "groups": report,
           "latex": latex_table(rows) if rows else ""}
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "report.json", "w") as f:
            json.dump(out, f, indent=2)
        with open(out_dir / "table.tex", "w") as f:
            f.write(out["latex"])
        if curves:
            # the figure is optional: without matplotlib (or with a backend
            # that fails) the report and the table above stand
            try:
                plot_multiple_curves(curves, out_dir / "mse_curves.png",
                                     ylabel="MSE per timestep")
            except Exception as e:
                print(f"plotting skipped: {e}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", type=str, default="results")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--exclude", nargs="*", default=["transplant*"],
                        help="fnmatch dir patterns to skip while scanning")
    args = parser.parse_args(argv)
    out = build_report(args.results, args.out, exclude=tuple(args.exclude))
    for key, g in out["groups"].items():
        print(f"{key}: test_loss {g['test_loss_mean']:.5f} "
              f"± {g['test_loss_std']:.5f} (seeds: {','.join(g['seeds'])})")


if __name__ == "__main__":
    main()
