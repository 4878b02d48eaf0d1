"""Where the time of the port's serving path goes, on one NVIDIA GPU.

    python scripts/profile_torch_serving.py [--data_dir data] [--batches 1]

Builds the canonical EGNO (model_confs.yaml:EGNO) from seed 42 on the card,
loads the charged-5 test split, runs one batch of the windowed test rollout
(batch 256, traj_len 20) to warm up, then traces ``--batches`` batches with
torch.profiler. Prints the host wall time, the summed device kernel time,
the device idle share (1 - kernel time / wall) and the kernels with the most
device time, with the card's name and power limit.
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
from nonode_tpu_torch.train.loop import EGNOExperiment  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", type=Path, default=Path("data"))
    ap.add_argument("--batches", type=int, default=1)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    model = EGNO(device=dev, generator=torch.Generator().manual_seed(42))
    ds = NBodyDataset(args.data_dir, partition="test", traj_len=20, device=dev)
    exp = EGNOExperiment(model)
    idx_np = exp.epoch_index_arrays(ds, np.random.RandomState(42))
    idx_arrays = {k: torch.from_numpy(v).to(dev) for k, v in idx_np.items()}
    arrays = (ds.loc, ds.vel, ds.charges, ds.edge_weights)
    batches = [exp._batch(arrays, idx_arrays,
                          torch.arange(256 * i, 256 * (i + 1), device=dev))
               for i in range(args.batches + 1)]

    exp.rollout(batches[0], 20, "charged")               # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            exp.rollout(b, 20, "charged")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"rollout of {args.batches} batch(es) x 20 windows: wall "
          f"{wall * 1e3:.3f} ms (traced), device kernel time "
          f"{device_us / 1e3:.3f} ms over {launches} kernel launches, "
          f"device idle share {1 - device_us / 1e6 / wall:.4f}")
    if not events:
        print("no device time in the trace")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    t0 = time.perf_counter()
    for b in batches[1:]:
        exp.rollout(b, 20, "charged")
    torch.cuda.synchronize()
    print(f"untraced rollout wall: {(time.perf_counter() - t0) * 1e3:.3f} ms")


if __name__ == "__main__":
    main()
