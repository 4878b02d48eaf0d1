"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python scripts/profile_torch_training.py [--model egno|segno]
        [--data_dir data] [--steps 2] [--fleet K]

Builds the model at its model_confs.yaml width (EGNO by default; SEGNO with
``--model segno``) from seed 42 on the card, loads the charged-5 train
split, takes one Adam-L2 step on a batch of 256 to warm up, then traces
``--steps`` steps with torch.profiler. Prints the host wall time, the summed
device kernel time, the device idle share (1 - kernel time / wall) and the
kernels with the most device time, with the card's name and power limit;
then the device time a step by the innermost ``nonode:`` span of the
program (``utils/profiling.py:span``) around the host op that launched each
kernel, with the kernels that take the most of it; then the untraced wall
of as many other steps. With ``--fleet K`` a step is
a seed fleet's (parallel/fleet.py): K seeds 1 .. K, each on its own batch
of 256, as fleet_main trains them. Both steps run eagerly: a step that
replays its CUDA graph (train/graphs.py) launches every kernel from one
host call, which no span can attribute.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nonode_tpu_torch.data.nbody import NBodyDataset  # noqa: E402
from nonode_tpu_torch.main import build_experiment, get_args  # noqa: E402
from nonode_tpu_torch.parallel.fleet import SeedFleet  # noqa: E402
from nonode_tpu_torch.runtime import resolve_device  # noqa: E402
from nonode_tpu_torch.utils.profiling import PREFIX  # noqa: E402

BATCH = 256
BACKWARD = "autograd::engine::evaluate_function"


def _innermost_span(e):
    """(the name of the innermost program span around host event ``e`` on
    its thread, the op under that span that holds ``e``); (None, None)
    where there is no span."""
    op = None
    while e is not None and not e.name.startswith(PREFIX):
        e, op = e.cpu_parent, e
    return (None, None) if e is None else (e.name[len(PREFIX):], op)


def device_us_by_span(events):
    """{span: {kernel: device µs}} of the profiler's ``events``: a kernel
    counts for the innermost program span around the host op that launched
    it (the profiler's correlation of a launch with its kernel gives each
    op its ``kernels``). An op of autograd's backward, which runs outside
    the forward's spans, counts for the span of the forward op that made
    its node (their sequence number), as ``<span> (backward of <op>)``,
    where ``<op>`` is the op directly under that span which made it; "none"
    where no span is found."""
    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD):
            span, op = _innermost_span(e)
            if span is not None:
                forward.setdefault((e.thread, e.sequence_nr),
                                   f"{span} (backward of "
                                   f"{(op or e).name})")
    by = defaultdict(lambda: defaultdict(float))
    for e in events:
        if not e.kernels:
            continue
        span, _ = _innermost_span(e)
        node = e
        while span is None and node is not None:
            if node.name.startswith(BACKWARD) and node.sequence_nr >= 0:
                span = forward.get((node.fwd_thread, node.sequence_nr))
                break
            node = node.cpu_parent
        for k in e.kernels:
            by[span or "none"][k.name] += k.duration
    return by


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["egno", "segno"], default="egno")
    ap.add_argument("--data_dir", type=Path, default=Path("data"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--fleet", type=int, default=0,
                    help="K > 0: a step of a K-seed fleet")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    margs = get_args(["--model", args.model])
    exp = build_experiment(margs, dev, torch.Generator().manual_seed(42))
    exp._steps.devices = ()                  # eager: kernels by span
    ds = NBodyDataset(args.data_dir, partition="train", device=dev)
    perm, windows = exp.draw_epoch(ds, np.random.RandomState(42), BATCH)

    def steps(rows):
        # one input: every batch's windows are batch 0's
        exp.train_epoch(ds, windows, rows)

    what = args.model
    if args.fleet:
        seeds = list(range(1, args.fleet + 1))
        fleet = SeedFleet(exp, seeds)
        fleet._steps.devices = ()            # eager: kernels by span
        params, opt = fleet.init(
            lambda g: build_experiment(margs, dev, g).model)
        perms = fleet.make_perms([np.random.RandomState(s) for s in seeds],
                                 len(ds), BATCH)
        perm = np.arange(perms.shape[1])     # steps index the fleet's batches

        def steps(rows):                     # noqa: F811
            fleet.train_epoch(params, opt, ds, windows, perms[:, rows])

        what = f"{args.model} fleet of {args.fleet} seeds"

    if len(perm) < 2 * args.steps + 1:
        raise ValueError(f"{len(perm)} batches: too few for {args.steps} "
                         f"traced and {args.steps} untraced steps")

    steps(perm[:1])                                       # warm-up
    torch.cuda.synchronize()
    traced = perm[1:1 + args.steps]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(traced)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels and copies only: a user annotation on the device timeline
    # (Optimizer.step#Adam.step) spans kernels that are counted already
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"{what}: {args.steps} training step(s) of batch {BATCH}: "
          f"wall {wall * 1e3:.3f} ms (traced), device kernel time "
          f"{device_us / 1e3:.3f} ms over {launches} kernel launches, "
          f"device idle share {1 - device_us / 1e6 / wall:.4f}")
    if not events:
        print("no device time in the trace")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    by = device_us_by_span(prof.events())
    total = sum(sum(k.values()) for k in by.values())
    print(f"device ms a step by the innermost nonode: span (kernels "
          f"{total / 1e3 / args.steps:.3f} ms a step):")
    for span, kernels in sorted(by.items(), key=lambda kv:
                                -sum(kv[1].values())):
        print(f"  {sum(kernels.values()) / 1e3 / args.steps:9.3f} ms  "
              f"{span}")
        for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:3]:
            print(f"  {'':9} {us / 1e3 / args.steps:9.3f} ms  {name[:80]}")
    t0 = time.perf_counter()
    steps(perm[1 + args.steps:1 + 2 * args.steps])
    torch.cuda.synchronize()
    print(f"untraced wall: {(time.perf_counter() - t0) * 1e3 / args.steps:.3f} "
          f"ms per step")


if __name__ == "__main__":
    main()
