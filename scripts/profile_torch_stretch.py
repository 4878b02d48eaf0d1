"""Where the time of the port's 1000-body charged stretch run goes, on one
NVIDIA GPU.

    python scripts/profile_torch_stretch.py [--n_balls 1000] [--T 20000]
    python scripts/profile_torch_stretch.py --probe [--n_balls 1000]

Runs ``LargeNChargedSim(n_balls).sample_trajectory`` (sample_freq 100, seed
42) once untraced to warm up and time it (host clock closed by a device
sync), then once under torch.profiler. Prints the card's name and power
limit, both walls, the summed device kernel time, the device idle share
(1 - kernel time / traced wall) and the kernels with the most device time.

With ``--probe`` it times instead, by CUDA events, the charged block kernel
(a 99-step block, as the stretch run launches it) beside the probe of the
same source, its micro-steps without the pair sums
(``nbody_sim.leapfrog_probe``): what a micro-step costs besides the force
pass, in this design and in each part of the earlier grid-barrier
design.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import device_ms  # noqa: E402
from nonode_tpu_torch.ops.kernels import nbody_sim  # noqa: E402
from nonode_tpu_torch.runtime import resolve_device  # noqa: E402
from nonode_tpu_torch.sim.large import LargeNChargedSim  # noqa: E402
from nonode_tpu_torch.sim.simulators import ChargedSim  # noqa: E402

STEPS = 99                  # the stretch run's blocks: sample_freq - 1


def probe(n, dev):
    """The block kernel beside its step loop without the pair sums."""
    loc, vel, _, q = (a.to(dev) for a in ChargedSim(n_balls=n).init_state(
        torch.Generator().manual_seed(n)))
    kernel = device_ms(lambda: nbody_sim.charged_leapfrog(loc, vel, q, STEPS))
    print(f"charged block kernel, N={n}, {STEPS} steps: {kernel:.4f} ms, "
          f"{1e3 * kernel / STEPS:.3f} us per micro-step")
    print(f"launch: {nbody_sim.launch_shape(n)}")
    probe_ms = {}
    for scheme, what in nbody_sim.PROBE_SCHEMES.items():
        ms = probe_ms[scheme] = device_ms(lambda: nbody_sim.leapfrog_probe(
            loc, vel, q, STEPS, scheme=scheme))
        print(f"probe {scheme} ({what}; no pair sums): {ms:.4f} ms, "
              f"{1e3 * ms / STEPS:.3f} us per micro-step, "
              f"{ms / kernel:.3f} of the kernel")
    us = {k: 1e3 * v / STEPS for k, v in probe_ms.items()}
    print(f"split of a micro-step, us: force pass "
          f"{1e3 * kernel / STEPS - us[1]:.3f}, waiting for other SMs "
          f"{us[1] - us[2]:.3f}, one read of the words {us[2] - us[3]:.3f}, "
          f"the rest (barriers, sums, updates) {us[3]:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_balls", type=int, default=1000)
    ap.add_argument("--T", type=int, default=20000)
    ap.add_argument("--probe", action="store_true",
                    help="time the block kernel beside its probe instead")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    if args.probe:
        probe(args.n_balls, dev)
        return
    sim = LargeNChargedSim(n_balls=args.n_balls)

    def run():
        gen = torch.Generator().manual_seed(42)
        t0 = time.perf_counter()
        sim.sample_trajectory(gen, args.T, 100, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    untraced = run()                            # also the warm-up (build)
    untraced = min(untraced, run())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"stretch run, {args.n_balls} bodies, {args.T} steps: wall "
          f"{untraced * 1e3:.3f} ms untraced (best of two), {wall * 1e3:.3f} "
          f"ms traced; device kernel time {device_us / 1e3:.3f} ms over "
          f"{launches} kernel launches, device idle share "
          f"{1 - device_us / 1e6 / wall:.4f}")
    if not events:
        print("no device time in the trace")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
