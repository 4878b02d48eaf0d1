"""Where the time of the port's 1000-body charged stretch run goes, on one
NVIDIA GPU.

    python scripts/profile_torch_stretch.py [--n_balls 1000] [--T 20000]
    python scripts/profile_torch_stretch.py --probe [--n_balls 1000]
    python scripts/profile_torch_stretch.py --forces [--n_balls 1000]

Runs ``LargeNChargedSim(n_balls).sample_trajectory`` (sample_freq 100, seed
42) once untraced to warm up and time it (host clock closed by a device
sync), then once under torch.profiler. Prints the card's name and power
limit, both walls, the summed device kernel time, the device idle share
(1 - kernel time / traced wall), where the idle device time lies (before
the first block kernel, between block kernels, after the last) and the
kernels with the most device time.

With ``--probe`` it times instead, by CUDA events, the charged block kernel
(a 100-step block recording its last micro-step, as the stretch run
launches it a frame) beside the probe of the same source, its micro-steps
without the pair sums (``nbody_sim.leapfrog_probe``): what a micro-step
costs besides the force pass, in this design and in each part of the
earlier grid-barrier design.

With ``--forces`` it times the two force kernels (``pairwise.charged_force``
and ``gravity_accel``) beside an empty one-thread launch
(``torch.cuda._sleep(0)``), each by CUDA events as chip_smoke.py times a
kernel (the launch's latency on the device included) and as the kernel's
own duration in torch.profiler's trace: the floor under a standalone
launch. It runs on any tree whose kernels take these calls.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import device_ms  # noqa: E402
from nonode_tpu_torch.ops.kernels import nbody_sim, pairwise  # noqa: E402
from nonode_tpu_torch.runtime import resolve_device  # noqa: E402
from nonode_tpu_torch.sim.large import LargeNChargedSim  # noqa: E402
from nonode_tpu_torch.sim.simulators import (ChargedSim,  # noqa: E402
                                             GravitySim)

STEPS = 100                 # the stretch run's blocks: sample_freq
RUN = "stretch run"         # the traced run's range


def probe(n, dev):
    """The block kernel beside its step loop without the pair sums."""
    loc, vel, _, q = (a.to(dev) for a in ChargedSim(n_balls=n).init_state(
        torch.Generator().manual_seed(n)))
    rec = (torch.empty_like(loc), torch.empty_like(vel))
    kernel = device_ms(lambda: nbody_sim.charged_leapfrog(loc, vel, q, STEPS,
                                                          record=rec))
    print(f"charged block kernel, N={n}, {STEPS} steps, the last recorded: "
          f"{kernel:.4f} ms, "
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


def device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda
            and not getattr(e, "is_user_annotation", False)]


def profiled_us(fn, reps=50):
    """Mean device time of one call of fn in torch.profiler's trace: the
    durations of its kernels, their launch latency left out."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(prof)) / reps


def forces(n, dev):
    """The force kernels at n bodies beside an empty one-thread launch."""
    gen = torch.Generator().manual_seed(n)
    loc, _, _, q = (a.to(dev) for a in ChargedSim(n_balls=n).init_state(gen))
    pos, _, mass = (a.to(dev) for a in GravitySim(n_balls=n).init_state(gen))
    for label, fn in (("empty launch (torch.cuda._sleep(0))",
                       lambda: torch.cuda._sleep(0)),
                      (f"nbody_charged_force, N={n}",
                       lambda: pairwise.charged_force(loc, q)),
                      (f"nbody_gravity_accel, N={n}",
                       lambda: pairwise.gravity_accel(pos, mass))):
        events_us = 1e3 * device_ms(fn, iters=50)
        print(f"{label}: {events_us:.3f} us by CUDA events, "
              f"{profiled_us(fn):.3f} us in the profiler")


def idle_split(prof):
    """Where the traced run's device idles, in ms: from the run's start (its
    range on the host) to the first block kernel, between the block kernels
    (the launches the host loop makes), and after the last one to the
    run's end."""
    dtype = torch.autograd.DeviceType
    events = prof.profiler.kineto_results.events()
    start, end = next((e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in events
                      if e.device_type() == dtype.CPU and e.name() == RUN)
    ops = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events
                  if e.device_type() == dtype.CUDA and e.name() != RUN),
                 key=lambda o: o[0])
    blocks = [o for o in ops if "leapfrog_kernel" in o[2]]
    if not blocks:
        print("no block kernel in the trace")
        return
    busy = lambda lo, hi: sum(max(0, min(b, hi) - max(a, lo))
                              for a, b, _ in ops)
    idle = lambda lo, hi: (hi - lo - busy(lo, hi)) / 1e6
    first, last = blocks[0][0], blocks[-1][1]
    between = idle(first, last)
    print(f"device idle: {idle(start, first):.3f} ms before the first block "
          f"kernel, {between:.3f} ms between the {len(blocks)} block kernels "
          f"({1e3 * between / max(1, len(blocks) - 1):.3f} us a launch), "
          f"{idle(last, end):.3f} ms after the last")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_balls", type=int, default=1000)
    ap.add_argument("--T", type=int, default=20000)
    ap.add_argument("--probe", action="store_true",
                    help="time the block kernel beside its probe instead")
    ap.add_argument("--forces", action="store_true",
                    help="time the force kernels beside an empty launch "
                         "instead")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    if args.probe:
        probe(args.n_balls, dev)
        return
    if args.forces:
        forces(args.n_balls, dev)
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
        with record_function(RUN):
            wall = run()
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"stretch run, {args.n_balls} bodies, {args.T} steps: wall "
          f"{untraced * 1e3:.3f} ms untraced (best of two), {wall * 1e3:.3f} "
          f"ms traced; device kernel time {device_us / 1e3:.3f} ms over "
          f"{launches} kernel launches, device idle share "
          f"{1 - device_us / 1e6 / wall:.4f}")
    if not events:
        print("no device time in the trace")
    idle_split(prof)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
