"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python scripts/profile_torch_training.py [--data_dir data] [--steps 2]

Builds the canonical EGNO (model_confs.yaml:EGNO) from seed 42 on the card,
loads the charged-5 train split, takes one Adam-L2 step on a batch of 256 to
warm up, then traces ``--steps`` steps with torch.profiler. Prints the host
wall time, the summed device kernel time, the device idle share (1 - kernel
time / wall) and the kernels with the most device time, with the card's name
and power limit; then the untraced wall of the same steps.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nonode_tpu_torch.data.nbody import NBodyDataset  # noqa: E402
from nonode_tpu_torch.models.egno import EGNO  # noqa: E402
from nonode_tpu_torch.runtime import resolve_device  # noqa: E402
from nonode_tpu_torch.train.loop import EGNOExperiment, make_perm  # noqa: E402

BATCH = 256


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", type=Path, default=Path("data"))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    model = EGNO(device=dev, generator=torch.Generator().manual_seed(42))
    ds = NBodyDataset(args.data_dir, partition="train", device=dev)
    exp = EGNOExperiment(model)
    rng = np.random.RandomState(42)
    perm = make_perm(rng, len(ds), BATCH)
    idx_np = exp.epoch_index_arrays(ds, rng)
    if len(perm) < 2 * args.steps + 1:
        raise ValueError(f"{len(perm)} batches: too few for {args.steps} "
                         f"traced and {args.steps} untraced steps")

    exp.train_epoch(ds, idx_np, perm[:1])                 # warm-up
    torch.cuda.synchronize()
    traced = perm[1:1 + args.steps]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.train_epoch(ds, idx_np, traced)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels and copies only: a user annotation on the device timeline
    # (Optimizer.step#Adam.step) spans kernels that are counted already
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"{args.steps} training step(s) of batch {BATCH}: wall "
          f"{wall * 1e3:.3f} ms (traced), device kernel time "
          f"{device_us / 1e3:.3f} ms over {launches} kernel launches, "
          f"device idle share {1 - device_us / 1e6 / wall:.4f}")
    if not events:
        print("no device time in the trace")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    t0 = time.perf_counter()
    exp.train_epoch(ds, idx_np, perm[1 + args.steps:1 + 2 * args.steps])
    torch.cuda.synchronize()
    print(f"untraced wall: {(time.perf_counter() - t0) * 1e3 / args.steps:.3f} "
          f"ms per step")


if __name__ == "__main__":
    main()
