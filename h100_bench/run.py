"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. ``BENCHMARK.json`` names the cell; everything that belongs to its
configuration, its traffic mix and its metrics is found by name:
``h100_bench/configs/<config>.json`` (the configuration, also handed to
the program as its preset), ``h100_bench/traffic/<mix>.py`` with its
parameters in ``<mix>.json`` (the set-up, the window, the profiled stretch
and the checks), ``h100_bench/metrics/<metric>.py`` (a per-layer reader)
and ``h100_bench/limits/<cell>.json`` (the limit of each number
compared). The program builds its kernels once a checkout, into
``nonode_tpu_torch/_build/`` inside it; no cell runs a Triton, Inductor
or torch-extension build.

A run sets up (data and weights from the seed, the program, its warm-up:
``setup_s`` from process start), measures for ``--seconds`` (``--trace
0``: the cell's end-to-end metrics), or with ``--trace 1`` measures the
same window untraced for the ``mfu`` metrics and then profiles the mix's
bounded stretch for the other per-layer metrics. Then it reads the peak
memory, frees the program's state and checks what the program produced
against the plain reference. The last lines on standard error are the
numbers compared beside their limits; the last line on standard output
is the result as one JSON object."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

import torch  # noqa: E402

from h100_bench import compare, inputs, trace  # noqa: E402

# top-level module names that may not be loaded where the result is made
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nonode_tpu")


def load_manifest(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def mix_module(name, here=HERE):
    return load_module(here / "traffic" / f"{name}.py",
                       "h100_bench_traffic_" + name.replace("-", "_")
                       .replace(".", "_"))


def metric_reader(name, here=HERE):
    return load_module(here / "metrics" / f"{name}.py",
                       "h100_bench_metric_" + name.replace("-", "_")
                       .replace(".", "_"))


def cell_metrics(manifest, cell, kind):
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') this cell
    reports: those without a ``workloads`` list, and those that list it."""
    return [m for m in manifest[kind]
            if cell in m.get("workloads", [cell])]


def context(manifest, cell, seed, device, overrides=None, here=HERE):
    """The cell's Context; ``overrides`` ({'cfg': {...}, 'params':
    {...}}) change its configuration or mix for tests at a small size."""
    entry = by_name(manifest["workloads"], cell, "workload")
    cfg_path = here / "configs" / f"{entry['config']}.json"
    cfg = json.loads(cfg_path.read_text())
    params = json.loads((here / "traffic" / f"{entry['traffic']}.json")
                        .read_text())
    overrides = overrides or {}
    cfg.update(overrides.get("cfg", {}))
    params.update(overrides.get("params", {}))
    if overrides.get("cfg"):
        cfg_path = Path(overrides["cfg_dir"]) / cfg_path.name
        cfg_path.write_text(json.dumps(cfg))
    return entry, inputs.Context(name=cell, cfg=cfg, cfg_path=cfg_path,
                                 params=params, seed=seed, device=device)


def limits_of(cell, here=HERE):
    return json.loads((here / "limits" / f"{cell}.json").read_text())


def run(manifest, cell, seed, seconds, traced, device, t0=T0,
        overrides=None, here=HERE):
    """One run of ``cell``; returns the result (without printing)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry, ctx = context(manifest, cell, seed, device, overrides, here)
    mix = mix_module(entry["traffic"], here)
    limits = limits_of(cell, here)
    ctx.mark("imports", t0)
    st = mix.setup(ctx)
    setup_s = time.perf_counter() - t0
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 ctx.phases.items()), file=sys.stderr)
    work = mix.window(st, seconds)
    units = sorted(b - a for a, b in zip([0.0] + work["unit_ends"],
                                         work["unit_ends"]))
    print(f"window: {len(units)} units in {work['wall_s']:.3f} s, "
          f"{units[0]:.3f} / {units[len(units) // 2]:.3f} / {units[-1]:.3f} "
          f"s the shortest / median / longest", file=sys.stderr)
    metrics = {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1}
    breakdown = None
    if traced:
        record = trace.capture(lambda: mix.stretch(st), device) \
            if device.type == "cuda" else None
        for m in cell_metrics(manifest, cell, "per_layer"):
            value = metric_reader(m["name"], here).read(
                record=record, window=work, cfg=ctx.cfg)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if record is not None:
            dev_info.update(busy_s=trace.busy_s(record),
                            window_s=record["wall_s"])
            breakdown = {"device_ops": trace.top_device_ops(record),
                         "idle_gaps": trace.idle_gaps(record)}
    else:
        e2e = dict(work["end_to_end"], setup_s=setup_s)
        for m in cell_metrics(manifest, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
    else:
        dev_info["memory_peak_bytes"] = 0
    cap = mix.release(st)
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = mix.gaps(cap, compare.references(mix, cap), cap)
    print(f"checks: {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    for name, at in numbers.items():
        if isinstance(at, str):
            print(f"worst {name}: {at}", file=sys.stderr)
    checks = {name: {"value": _number(numbers.get(name, math.inf)),
                     "limit": limit} for name, limit in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": work["attempted"],
              "failed": work["failed"], "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _number(x):
    x = float(x)
    return x if math.isfinite(x) else None


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules, compared
    whole (``nonode_tpu_torch`` is not ``nonode_tpu``)."""
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest()
    entry = by_name(manifest["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run(manifest, args.workload, args.seed, args.seconds,
                 bool(args.trace), device)
    leaked = forbidden_loaded()
    if leaked:
        print(f"loaded in the result's process: {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
