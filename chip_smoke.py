#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nonode_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed on its own line:
1. card: the GPU's name and power limit from nvidia-smi;
2. build: every CUDA kernel of the port, from nonode_tpu_torch/csrc/, one
   nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and on the edge cases, then both timed; every
   kernel twice, bitwise equal; the EGNO kernels (split TF32 on the tensor
   cores) within 1e-5 relative at the slice shape, with their bound on that
   route beside the fp32 one; the charged block kernel as the stretch run
   launches it (100 micro-steps recording the last) beside a 99-step block
   without records; the leapfrog block kernels' launch and time a
   micro-step, and the share of it that the probe without the pair sums
   takes; the force kernels' launch; then the first 3 frames of the stretch
   run, one recorded block each, bitwise against the chain they replace
   (a 99-step block, the drift, the record, the force kernel, the kick);
4. main path: ``nonode_tpu_torch.main --model egno --only_test true`` on the
   committed charged-5 test split at the canonical EGNO width (4 layers,
   hidden 64, T=10, batch 256, traj_len 20), weights from --seed 42. Checks
   the artifact's shapes, the kernel launch counts, and the first two windows
   of batch 0 against the port's own CPU rollout of the same weights;
5. train path: ``main --model egno --only_test false --epochs 2
   --test_interval 1`` at the same width on the committed train, valid and
   test splits: training, validation at epoch 1, the best checkpoint saved
   and reloaded, the test rollout. Checks the launch counts of both kernels,
   finite losses, the checkpoint and the artifact;
6. train step: the loss and the gradient of every parameter on train batch 0
   from the seed-42 weights, card against the port's CPU; then the median
   wall of a training step;
7. stretch: the 1000-body charged run (as bench.py:bench_large_n),
   ``LargeNChargedSim(n_balls=1000)``, T=20000, sample_freq 100, from
   --seed 42: 199 finite frames, 1 launch of the force kernel (the kick
   before the loop) and 199 of the charged block kernel (a frame each), the
   energy drift in float64 under 5 x the
   first frame's kinetic energy (tests/test_large_sim.py:80-103); then the
   port's large-N and dense charged simulators from one state (N=20,
   T=300) on the card;
8. gravity: ``LargeNGravitySim(n_balls=1000)``, T=2000, sample_freq 100:
   20 launches of the gravity block kernel and 1 of the gravity kernel,
   total momentum conserved; then large-N against dense (N=40, T=300);
9. generate: ``python -m nonode_tpu_torch.sim.generate --simulation gravity``
   (in-process) writes small gravity splits on the card; ``main --dataset
   gravity --only_test false --epochs 1`` trains and rolls out on them.

Every kernel's time is its device time alone (CUDA events around one call,
the stream held busy while the host enqueues it), median of repeats. Then it
prints the kernels line (each kernel's launches on its own path, and on
every path) and, last, one JSON line with the device. It exits non-zero,
with no result, without CUDA, outside the repository, or when the checkout
lacks the committed splits.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 42
BATCH, TRAJ_LEN, LAYERS = 256, 20, 4
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3,
# TF32 on the tensor cores (dense).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12
# kernel vs plain version: fp32 on both sides, sums of <= 64 products taken
# in another order
KERNEL_RTOL = 1e-4
# the EGNO kernels at the slice shape: split TF32 keeps fp32-class error
# (about 2^-21 a product; tests/test_torch_tf32_split.py), a single TF32 pass
# would read about 1e-3
SPLIT_TF32_RTOL = 1e-5
# card vs CPU over two fed-back windows of the 4-layer model, and for the
# gradients of one training step: the same fp32 arithmetic in another order
# (cuBLAS, cuFFT and the kernels against the CPU) through 4 layers
ROLLOUT_RTOL = 1e-3
GRAD_RTOL = 1e-3
SPLITS = ("test", "train", "valid")
# N-body pair work: 22 fp32 operations per interacting pair (bench.py:359-363
# counts them for the TPU kernel: difference 3, r^2 5, rsqrt and cube 4,
# scale 2, accumulate 6, clip and integrate 2) and one rsqrt on the
# special-function units: 16 per clock per SM, 132 SMs at 1.98 GHz (the
# same rate bounds the EGNO kernels' exps and reciprocals).
FLOP_PER_PAIR = 22
PEAK_RSQRT = 16 * 132 * 1.98e9
# per kernel: fp32 values read and written per body (the charged block with
# the records that the stretch run asks for)
NBODY_IO = {"nbody_charged_force": (4, 3), "nbody_gravity_accel": (4, 3),
            "nbody_charged_leapfrog": (7, 12),
            "nbody_gravity_leapfrog": (10, 9)}
STRETCH_N, STRETCH_T, SAMPLE_FREQ = 1000, 20000, 100
GRAVITY_T = 2000
# the stretch run's envelope: tests/test_large_sim.py:80-103, max |E_t - E_0|
# over the first frame's kinetic energy (the force clip is not
# Hamiltonian; the JAX package's recorded run reached 2.05)
DRIFT_LIMIT = 5.0
# total momentum of the gravity run, |P_t - P_0| over sum_i m_i |v_i(t)|:
# pairwise forces cancel up to fp32 rounding (about 1e-7 of the frame's
# scale after 2000 steps); one pair dropped for a block of steps moves it by
# about 1e-2
MOMENTUM_LIMIT = 1e-5
# large-N vs dense simulators on the card (tests/test_large_sim.py:18-46):
# positions 2e-4 x max|pos|, gravity's velocities 2e-3
SIM_POS_RTOL, SIM_VEL_ATOL = 2e-4, 2e-3
SLEEP_CYCLES = 2_000_000           # about 1 ms of the stream held busy


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters=20, warmup=3):
    """Median device time of one call of ``fn``: CUDA events recorded just
    before and after the call, with the stream held busy (about 1 ms) while
    the host enqueues it, so that the host's time counts only where it
    outlasts the hold (as for a plain version of many small launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def pairwise_inputs(g, n, h, e, seed, dev, coord_scale=1.0, isolated=None):
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.tensor(scale * rng.randn(*shape), dtype=torch.float32,
                            device=dev)

    x, hi, hj, efea = f(g, n, 3), f(g, n, h, scale=0.5), \
        f(g, n, h, scale=0.5), f(g, n, n, e)
    mask = 1.0 - torch.eye(n, device=dev)
    if isolated is not None:      # a mocap-like sparse graph with a lone node
        adj = torch.tensor(rng.rand(n, n) < 0.3, dtype=torch.float32,
                           device=dev)
        adj = torch.maximum(adj, adj.T)
        adj[isolated] = 0.0
        adj[:, isolated] = 0.0
        mask = mask * adj
    b = 1.0 / np.sqrt(h)
    weights = (f(1, h, scale=0.3), f(e, h, scale=0.3), f(1, h, scale=0.1),
               f(h, h, scale=b), f(1, h, scale=0.1), f(h, h, scale=b),
               f(1, h, scale=0.1), f(h, 1, scale=coord_scale * b),
               f(1, 1, scale=0.1))
    return x, hi, hj, efea, mask, weights


def pairwise_flops_per_edge(h, e):
    """FLOP of the chain's forward for one edge: the three products as
    multiply-adds (2 FLOP each: a1 @ W2, msg @ Wc1, ca . wc2) and the first
    layer's r2 wg and efea @ We, plus 12 FLOP per hidden unit for bias adds
    and the three SiLUs."""
    return 2 * (2 * h * h + h + e * h + h) + 12 * h


def pairwise_bytes(g, n, h, e, backward=False):
    """Bytes the chain (or its backward) must move: each input read once,
    each output written once."""
    weights = 2 * h * h + 5 * h + e * h + 1
    inputs = g * n * 3 + 2 * g * n * h + g * n * n * e + n * n + weights
    outputs = g * n * 3 + g * n * h
    if backward:
        inputs += g * n * 3 + g * n * h                   # the cotangents
        outputs = g * n * 3 + 2 * g * n * h + g * n * n * e + weights
    return 4 * (inputs + outputs)


def pairwise_bound_ms(g, mask, h, e):
    """Least time for the pairwise chain on an H100 SXM: the larger of its
    operations over the fp32 peak and its bytes (each input read once, each
    output written once) over the HBM rate. The operations are those of the
    edges the [N, N] mask keeps, the only ones the outputs depend on
    (pairwise_flops_per_edge each)."""
    n = mask.shape[-1]
    edges = g * int((mask != 0).sum())
    t_ops = edges * pairwise_flops_per_edge(h, e) / PEAK_FP32_FLOPS
    t_bytes = pairwise_bytes(g, n, h, e) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def pairwise_tc_bound_ms(g, mask, h, e, backward=False):
    """Least time for the chain (or its backward) on the route its kernels
    take: the HxH products (2 forward, 6 backward, 2 H^2 FLOP each per kept
    edge) three times over, as split TF32, on the tensor cores at the TF32
    peak; the rest of the FLOP (pairwise_flops_per_edge or
    pairwise_bwd_flops_per_edge less the products) on the fp32 CUDA cores;
    three SiLUs per hidden unit, an exp and a reciprocal each, on the
    special-function units; the bytes as in the fp32 bound. The pipes work
    side by side, so the bound is the longest of the four. Returns (ms, the
    pipe that sets it)."""
    n = mask.shape[-1]
    edges = g * int((mask != 0).sum())
    products = (6 if backward else 2) * 2 * h * h
    total = (pairwise_bwd_flops_per_edge(h, e) if backward
             else pairwise_flops_per_edge(h, e))
    times = {"tensor cores": edges * 3 * products / PEAK_TF32_FLOPS,
             "CUDA cores": edges * (total - products) / PEAK_FP32_FLOPS,
             "special-function units": edges * 3 * h * 2 / PEAK_RSQRT,
             "bytes": pairwise_bytes(g, n, h, e, backward) / PEAK_BYTES}
    pipe = max(times, key=times.get)
    return 1e3 * times[pipe], pipe


def route_row(ms, fp32_bound, tc_bound):
    """The kernels line's bound keys for an EGNO kernel: the split-TF32
    bound its route is held to, with the fp32 bound beside it."""
    (bound_ms, pipe), (fp32_ms, fp32_by) = tc_bound, fp32_bound
    return dict(bound_ms=bound_ms,
                bound_by="bytes" if pipe == "bytes" else "operations",
                bound_pipe=pipe, fp32_bound_ms=fp32_ms, fp32_bound_by=fp32_by,
                bound_share=bound_ms / ms)


def bounds_text(fp32_bound, tc_bound, ms):
    (fp32_ms, fp32_by), (tc_ms, pipe) = fp32_bound, tc_bound
    return (f"bound {tc_ms:.4f} ms in split TF32 (set by the {pipe}; the "
            f"route's bound, {tc_ms / ms:.3f} of it), {fp32_ms:.4f} ms in "
            f"fp32 on the CUDA cores (by {fp32_by})")


def check_pairwise_kernel(egnn_fused, dev):
    """Kernel vs plain version in three cases; returns the slice-shape row."""
    cases = [("slice G=2560 N=5 H=64 E=2", dict(g=2560, n=5), False),
             ("clip_edges=True", dict(g=2560, n=5, coord_scale=400.0), True),
             ("2-D edge_mask N=31 (mocap)", dict(g=256, n=31, isolated=3),
              False)]
    row = None
    for label, kw, clip in cases:
        g, n = kw.pop("g"), kw.pop("n")
        args = pairwise_inputs(g, n, 64, 2, seed=n, dev=dev, **kw)
        with torch.no_grad():
            got = egnn_fused.pairwise_message(clip, *args)
            again = egnn_fused.pairwise_message(clip, *args)
            torch.cuda.synchronize()
            want = egnn_fused.pairwise_message_reference(clip, *args)
        errs = []
        for name, a, b, c in zip(("tot_f", "tot_m"), got, want, again):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: kernel {name} not finite")
            if not torch.equal(a, c):
                raise AssertionError(f"{label}: {name} differs between two "
                                     f"runs of the kernel")
            err = float((a - b).abs().max())
            scale = max(1.0, float(b.abs().max()))
            print(f"  {label}: {name} max_abs_err {err:.3e} "
                  f"max_rel_err {err / scale:.3e} "
                  f"(tolerance {KERNEL_RTOL:g} x max(1, max|plain|)); two "
                  f"runs bitwise equal", flush=True)
            if err > KERNEL_RTOL * scale:
                raise AssertionError(f"{label}: {name} disagrees with the "
                                     f"plain version: {err} > "
                                     f"{KERNEL_RTOL} x {scale}")
            if row is None and err > SPLIT_TF32_RTOL * scale:
                raise AssertionError(f"{label}: {name} relative error "
                                     f"{err / scale} over the split-TF32 "
                                     f"budget {SPLIT_TF32_RTOL}")
            errs.append(err)
        if row is None:
            with torch.no_grad():
                ms = device_ms(lambda: egnn_fused.pairwise_message(
                    clip, *args))
                plain_ms = device_ms(
                    lambda: egnn_fused.pairwise_message_reference(clip,
                                                                  *args))
            fp32 = pairwise_bound_ms(g, args[4], 64, 2)
            tc = pairwise_tc_bound_ms(g, args[4], 64, 2)
            kept = g * int((args[4] != 0).sum())
            print(f"  kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms "
                  f"(no yardstick), {bounds_text(fp32, tc, ms)}, over the "
                  f"{kept} edges the mask keeps; the kernel also computes "
                  f"the {g * n * n - kept} masked-out edge rows; no single "
                  f"PyTorch call computes this function; slice-shape "
                  f"relative error within {SPLIT_TF32_RTOL:g}", flush=True)
            row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                       library_ms=None, **route_row(ms, fp32, tc))
    return row


def pairwise_bwd_flops_per_edge(h, e):
    """FLOP of the chain's backward for one edge, recomputation included.
    Products as multiply-adds (2 FLOP each): the recomputed a1 @ W2,
    msg @ Wc1, ca . wc2 and efea @ We; the backward's dcpre @ Wc1^T,
    dpre2 @ W2^T, dpre1 . wg and dpre1 @ We^T; the weight gradients
    a1^T dpre2, msg^T dcpre, efea^T dpre1, r2 dpre1 and ca dcw: 6H^2 + 3EH
    + 4H multiply-adds. Per hidden unit, 41 FLOP of elementwise work,
    counting a SiLU or its derivative as 4: pre1's r2 wg and three adds (4),
    three SiLUs and the b2 and bc1 adds (14), dcpre (6), dmsg's mask term and
    dpre2 (7), dpre1 (5), the db1, db2 and dbc1 sums (3), and the dhi and dhj
    sums (2). Per edge, 38 FLOP of 3-vector work: rij and r2 (8), the force
    and its gate (7), dcw (5), drij (3 + 9 with the r2 term) and the two dx
    sums (6)."""
    return 2 * (6 * h * h + 3 * e * h + 4 * h) + 41 * h + 38


def pairwise_bwd_bound_ms(g, mask, h, e):
    """Least time for the chain's backward on an H100 SXM: the larger of its
    operations (over the edges the mask keeps: a masked edge's gradient is
    zero) over the fp32 peak and its bytes (the forward's inputs and the two
    cotangents read once; dx, dhi, dhj, defea and the weight gradients
    written once) over the HBM rate."""
    n = mask.shape[-1]
    edges = g * int((mask != 0).sum())
    t_ops = edges * pairwise_bwd_flops_per_edge(h, e) / PEAK_FP32_FLOPS
    t_bytes = pairwise_bytes(g, n, h, e, backward=True) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_outputs(out):
    dx, dhi, dhj, defea, dweights = out
    return dict(zip(("dx", "dhi", "dhj", "defea", "dwg", "dwe", "db1", "dw2",
                     "db2", "dwc1", "dbc1", "dwc2", "dbc2"),
                    (dx, dhi, dhj, defea, *dweights)))


def check_pairwise_bwd_kernel(egnn_fused, dev):
    """Backward kernel vs plain version in the forward's cases, each run
    twice and held bitwise equal; returns the slice-shape row."""
    cases = [("slice G=2560 N=5 H=64 E=2", dict(g=2560, n=5), False),
             ("clip_edges=True", dict(g=2560, n=5, coord_scale=400.0), True),
             ("2-D edge_mask N=31 with an isolated node (mocap)",
              dict(g=256, n=31, isolated=3), False)]
    row = None
    for label, kw, clip in cases:
        g, n = kw.pop("g"), kw.pop("n")
        args = pairwise_inputs(g, n, 64, 2, seed=n + 1, dev=dev, **kw)
        rng = np.random.RandomState(n)
        cot = tuple(torch.tensor(rng.randn(*shape), dtype=torch.float32,
                                 device=dev)
                    for shape in ((g, n, 3), (g, n, 64)))
        got = bwd_outputs(egnn_fused.pairwise_message_bwd(clip, *args, *cot))
        again = bwd_outputs(egnn_fused.pairwise_message_bwd(clip, *args,
                                                            *cot))
        torch.cuda.synchronize()
        want = bwd_outputs(egnn_fused.pairwise_message_bwd_reference(
            clip, *args, *cot))
        if clip:
            free = egnn_fused.pairwise_message_bwd_reference(False, *args,
                                                             *cot)[0]
            if float((free - want["dx"]).abs().max()) <= 1e-3:
                raise AssertionError(f"{label}: the clip never engaged")
        worst = (0.0, "")
        errs = []
        for name, a in got.items():
            b = want[name]
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{label}: kernel {name} has shape "
                                     f"{tuple(a.shape)} or is not finite")
            if not torch.equal(a, again[name]):
                raise AssertionError(f"{label}: {name} differs between two "
                                     f"runs of the kernel")
            err = float((a - b).abs().max())
            scale = max(1.0, float(b.abs().max()))
            if err > KERNEL_RTOL * scale:
                raise AssertionError(f"{label}: {name} disagrees with the "
                                     f"plain version: {err} > "
                                     f"{KERNEL_RTOL} x {scale}")
            if row is None and err > SPLIT_TF32_RTOL * scale:
                raise AssertionError(f"{label}: {name} relative error "
                                     f"{err / scale} over the split-TF32 "
                                     f"budget {SPLIT_TF32_RTOL}")
            errs.append(err)
            worst = max(worst, (err / scale, name))
        print(f"  {label}: backward max_abs_err {max(errs):.3e}, worst "
              f"relative {worst[0]:.3e} ({worst[1]}; tolerance "
              f"{KERNEL_RTOL:g} x max(1, max|plain|) per output); two runs "
              f"bitwise equal", flush=True)
        if row is None:
            ms = device_ms(lambda: egnn_fused.pairwise_message_bwd(
                clip, *args, *cot))
            plain_ms = device_ms(
                lambda: egnn_fused.pairwise_message_bwd_reference(
                    clip, *args, *cot))
            fp32 = pairwise_bwd_bound_ms(g, args[4], 64, 2)
            tc = pairwise_tc_bound_ms(g, args[4], 64, 2, backward=True)
            print(f"  backward kernel {ms:.4f} ms (both launches), plain "
                  f"version {plain_ms:.4f} ms (no yardstick), "
                  f"{bounds_text(fp32, tc, ms)}; no single PyTorch call "
                  f"computes this function; slice-shape relative error "
                  f"within {SPLIT_TF32_RTOL:g}", flush=True)
            row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                       library_ms=None, **route_row(ms, fp32, tc))
    return row


def nbody_bound_ms(name, n, steps=1):
    """Least time for an N-body kernel on an H100 SXM: the larger of its
    operations and its bytes. Operations: the N(N-1) interacting pairs of
    each micro-step (a self pair does no work) at FLOP_PER_PAIR (the
    per-body clip and updates amortized in it) over the fp32 peak, or their
    rsqrts over the special-function units' rate, whichever is longer;
    bytes: each input read once and each output written once (NBODY_IO)
    over the HBM rate."""
    floats_in, floats_out = NBODY_IO[name]
    pairs = steps * n * (n - 1)
    t_ops = max(pairs * FLOP_PER_PAIR / PEAK_FP32_FLOPS, pairs / PEAK_RSQRT)
    t_bytes = 4 * n * (floats_in + floats_out) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbody_cases(name, dev):
    """(label, n, steps, wrapper args, records) of a kernel: the main path's
    shape first (N=1000; for the charged kernel a 100-step block that
    records its last micro-step, as the stretch run launches it a frame,
    then a 99-step block without records; a 100-step block for gravity),
    then the edge N. Inputs are the simulators' own initial states from a
    fixed seed."""
    from nonode_tpu_torch.ops.kernels.pairwise import gravity_accel_reference
    from nonode_tpu_torch.sim.simulators import ChargedSim, GravitySim

    path_steps = SAMPLE_FREQ if "leapfrog" in name else 1
    records = name == "nbody_charged_leapfrog"
    cases = [(STRETCH_N, path_steps, records)]
    if records:
        cases.append((STRETCH_N, SAMPLE_FREQ - 1, False))
    cases += [(n, path_steps, records) for n in (1, 5, 129)]
    for n, steps, record in cases:
        gen = torch.Generator().manual_seed(n)
        if "gravity" in name:
            pos, vel, mass = (a.to(dev) for a in
                              GravitySim(n_balls=n).init_state(gen))
            args = {"nbody_gravity_accel": (pos, mass),
                    "nbody_gravity_leapfrog": (
                        pos, vel, gravity_accel_reference(pos, mass), mass,
                        steps)}[name]
        else:
            loc, vel, _, q = (a.to(dev) for a in
                              ChargedSim(n_balls=n).init_state(gen))
            args = {"nbody_charged_force": (loc, q),
                    "nbody_charged_leapfrog": (loc, vel, q, steps)}[name]
        label = (f"N={n}" + (f" steps={steps}" if steps > 1 else "")
                 + (" with records" if record else ""))
        yield label, n, steps, args, record


def with_records(fn):
    """``charged_leapfrog`` or its plain version asked for the records, into
    new tensors: (pos, vel, recorded pos, recorded vel)."""
    def run(pos, vel, q, steps):
        rec = (torch.empty_like(pos), torch.empty_like(vel))
        return (*fn(pos, vel, q, steps, record=rec), *rec)
    return run


def check_nbody_kernels(dev):
    """Each N-body kernel against its plain version on the card at the
    path's shape and the edge N; the block kernels run twice and must agree
    bitwise. Returns the rows of the path's shape."""
    from nonode_tpu_torch.ops.kernels import nbody_sim, pairwise

    fns = {"nbody_charged_force": (pairwise.charged_force,
                                   pairwise.charged_force_reference),
           "nbody_gravity_accel": (pairwise.gravity_accel,
                                   pairwise.gravity_accel_reference),
           "nbody_charged_leapfrog": (nbody_sim.charged_leapfrog,
                                      nbody_sim.charged_leapfrog_reference),
           "nbody_gravity_leapfrog": (nbody_sim.gravity_leapfrog,
                                      nbody_sim.gravity_leapfrog_reference)}
    rows, blocks = {}, {}
    for name, fn_pair in fns.items():
        for label, n, steps, args, records in nbody_cases(name, dev):
            kernel, plain = (map(with_records, fn_pair) if records
                             else fn_pair)
            as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
            got = as_tuple(kernel(*args))
            again = as_tuple(kernel(*args))
            torch.cuda.synchronize()
            want = as_tuple(plain(*args))
            errs = []
            for k, (a, b) in enumerate(zip(got, want)):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise AssertionError(f"{name} {label}: output {k} has "
                                         f"shape {tuple(a.shape)} or is not "
                                         f"finite")
                if not torch.equal(a, again[k]):
                    raise AssertionError(f"{name} {label}: output {k} differs "
                                         f"between two runs of the kernel")
                err = float((a - b).abs().max())
                scale = max(1.0, float(b.abs().max()))
                if err > KERNEL_RTOL * scale:
                    raise AssertionError(f"{name} {label}: output {k} "
                                         f"disagrees with the plain version: "
                                         f"{err} > {KERNEL_RTOL} x {scale}")
                errs.append((err, err / scale))
            print(f"  {name} {label}: max_abs_err "
                  f"{max(e for e, _ in errs):.3e} max_rel_err "
                  f"{max(r for _, r in errs):.3e} (tolerance {KERNEL_RTOL:g} "
                  f"x max(1, max|plain|) per output); two runs bitwise equal",
                  flush=True)
            if n == STRETCH_N:
                ms = device_ms(lambda: kernel(*args))
                plain_ms = device_ms(lambda: plain(*args), iters=5)
                bound_ms, bound_by = nbody_bound_ms(name, n, steps)
                print(f"  {name} {label}: kernel {ms:.4f} ms, plain version "
                      f"{plain_ms:.4f} ms (no yardstick), bound "
                      f"{bound_ms:.4f} ms by {bound_by}; no single PyTorch "
                      f"call computes this function", flush=True)
                if name in rows:             # the charged block's 99 steps
                    rows[name].update({f"{steps}_steps_no_records_ms": ms,
                                       f"{steps}_steps_no_records_plain_ms":
                                       plain_ms})
                    continue
                rows[name] = dict(max_abs_err=max(e for e, _ in errs), ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=None,
                                  steps=steps)
                if "leapfrog" not in name:
                    shape = pairwise.launch_shape(n, "gravity" in name)
                    print(f"  {name} launch at N={n}: {json.dumps(shape)}",
                          flush=True)
                    rows[name]["launch"] = shape
                else:
                    blocks[name] = (nbody_sim.launch_shape(
                        n, gravity="gravity" in name), ms, steps)
                if name == "nbody_charged_leapfrog":
                    probe_ms = device_ms(lambda: nbody_sim.leapfrog_probe(
                        *args[:3], steps))
    print(f"  {block_kernels_line(STRETCH_N, blocks, probe_ms)}", flush=True)
    return rows


def check_fused_frames(dev, frames=3):
    """The first frames of the stretch run through the user's entry point
    (``LargeNChargedSim.integrate``: one recorded 100-step block a frame)
    against the chain they replace, written out: a 99-step block, the
    drift, the record, the force kernel and the kick on the host's stream.
    Bitwise: the force kernel sums in the block kernel's order, and both
    round the drift and the kick as PyTorch does."""
    from nonode_tpu_torch.ops.kernels import nbody_sim, pairwise
    from nonode_tpu_torch.sim.large import LargeNChargedSim

    sim = LargeNChargedSim(n_balls=STRETCH_N)
    state = tuple(a.to(dev) for a in
                  sim.init_state(torch.Generator().manual_seed(SEED)))
    locs, vels, _, _ = sim.integrate(state, (frames + 1) * SAMPLE_FREQ,
                                     SAMPLE_FREQ)
    loc, vel, _, q = state
    kw = dict(k=sim.interaction_strength, max_f=sim._max_f)
    vel = vel + sim.dt * pairwise.charged_force(loc, q, **kw)
    for f in range(frames):
        loc, vel = nbody_sim.charged_leapfrog(loc, vel, q, SAMPLE_FREQ - 1,
                                              dt=sim.dt, **kw)
        loc = loc + sim.dt * vel
        if not (torch.equal(locs[f], loc) and torch.equal(vels[f], vel)):
            raise AssertionError(
                f"fused frame {f} differs from the unfused chain: positions "
                f"by {float((locs[f] - loc).abs().max())}, velocities by "
                f"{float((vels[f] - vel).abs().max())}")
        vel = vel + sim.dt * pairwise.charged_force(loc, q, **kw)
    print(f"  stretch run's first {frames} frames, N={STRETCH_N}: one "
          f"recorded {SAMPLE_FREQ}-step block a frame bitwise equal to a "
          f"{SAMPLE_FREQ - 1}-step block, the drift, the record, the force "
          f"kernel and the kick", flush=True)


def block_kernels_line(n, blocks, probe_ms):
    """The block kernels at n bodies: each one's cooperative launch and
    device time a micro-step ({name: (launch_shape, ms, steps)}), then the
    probe's (the charged kernel's micro-steps without the pair sums: the
    exchange, staging and updates) time a micro-step and its share of the
    charged kernel's."""
    parts = []
    for name, (shape, ms, steps) in blocks.items():
        parts.append(
            f"{name} {shape['blocks']} blocks of {shape['threads']} threads "
            f"({shape['receivers_per_pass']} receivers a pass x "
            f"{shape['warps_per_receiver']} warps each, {shape['passes']} "
            f"pass{'es' if shape['passes'] > 1 else ''}), "
            f"{1e3 * ms / steps:.3f} us per micro-step")
    _, ms, steps = blocks["nbody_charged_leapfrog"]
    return (f"block kernels at N={n}: {'; '.join(parts)}; probe without the "
            f"pair sums {1e3 * probe_ms / steps:.3f} us per micro-step, "
            f"{probe_ms / ms:.3f} of the charged kernel's")


def reset_launches(kernels):
    for k in kernels:
        k["wrapper"].launches = 0


def read_launches(kernels, want, what):
    """The launch counts of every kernel since the reset; raises unless they
    are ``want`` (0 for a kernel it does not name)."""
    launches = {k["name"]: k["wrapper"].launches for k in kernels}
    expected = {k["name"]: want.get(k["name"], 0) for k in kernels}
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expected}")
    return launches


def run_stretch(kernels, dev):
    """The 1000-body charged stretch run through the user's entry point,
    then the large-N and dense simulators from one state."""
    from nonode_tpu_torch.sim.large import LargeNChargedSim
    from nonode_tpu_torch.sim.simulators import ChargedSim

    n, T, freq = STRETCH_N, STRETCH_T, SAMPLE_FREQ
    sim = LargeNChargedSim(n_balls=n)
    gen = torch.Generator().manual_seed(SEED)
    reset_launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loc, vel, edges, _ = sim.sample_trajectory(gen, T, freq, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames = T // freq - 1
    launches = read_launches(kernels, {"nbody_charged_force": 1,
                                       "nbody_charged_leapfrog": frames},
                             "stretch run (the kick before the loop, then "
                             "one recorded block a frame)")
    if loc.shape != (frames, n, 3) or not (torch.isfinite(loc).all()
                                           and torch.isfinite(vel).all()):
        raise AssertionError(f"stretch run: loc {tuple(loc.shape)}, "
                             f"expected ({frames}, {n}, 3), all finite")
    loc64, vel64, edges64 = loc.double(), vel.double(), edges.double()
    energy = torch.stack([sim.energy(loc64[f], vel64[f], edges64)
                          for f in range(frames)])
    k0 = 0.5 * float((vel64[0] ** 2).sum())
    drift = float((energy - energy[0]).abs().max()) / k0
    if not np.isfinite(drift) or drift >= DRIFT_LIMIT:
        raise AssertionError(f"stretch run: energy drift {drift} x K_0, "
                             f"limit {DRIFT_LIMIT}")
    print(f"  stretch run: {frames} frames of {n} bodies, {T} steps, wall "
          f"{wall:.3f} s (sync-closed), {n * n * T / wall / 1e9:.3f} G pair "
          f"interactions/s, energy drift max|E_t - E_0| / K_0 = {drift:.4f} "
          f"(limit {DRIFT_LIMIT}, float64), launches {json.dumps(launches)}",
          flush=True)

    dense, large = ChargedSim(n_balls=20), LargeNChargedSim(n_balls=20)
    state = tuple(a.to(dev) for a in
                  dense.init_state(torch.Generator().manual_seed(SEED)))
    want_loc = dense.integrate(state, 300, freq)[0]
    got_loc = large.integrate(state, 300, freq)[0]
    err = float((got_loc - want_loc).abs().max())
    scale = float(want_loc.abs().max())
    print(f"  large-N vs dense charged, N=20 T=300: max_abs_err {err:.3e} "
          f"(tolerance {SIM_POS_RTOL:g} x max|loc| = "
          f"{SIM_POS_RTOL * scale:.3e})", flush=True)
    if err > SIM_POS_RTOL * scale:
        raise AssertionError(f"large-N and dense charged disagree: {err}")
    return launches, wall


def run_gravity(kernels, dev):
    """The 1000-body gravity run through the user's entry point, then the
    large-N and dense simulators from one state."""
    from nonode_tpu_torch.sim.large import LargeNGravitySim
    from nonode_tpu_torch.sim.simulators import GravitySim

    n, T, freq = STRETCH_N, GRAVITY_T, SAMPLE_FREQ
    sim = LargeNGravitySim(n_balls=n)
    reset_launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos, vel, force, mass = sim.sample_trajectory(
        torch.Generator().manual_seed(SEED), T, freq, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames = T // freq
    launches = read_launches(kernels, {"nbody_gravity_leapfrog": frames,
                                       "nbody_gravity_accel": 1},
                             "gravity run")
    if pos.shape != (frames, n, 3) or not all(
            torch.isfinite(a).all() for a in (pos, vel, force)):
        raise AssertionError(f"gravity run: pos {tuple(pos.shape)}, expected "
                             f"({frames}, {n}, 3), all finite")
    m64, v64 = mass.double(), vel.double()
    momentum = (m64 * v64).sum(-2)                               # [T, 3]
    scale = (m64 * v64.norm(dim=-1, keepdim=True)).sum((-2, -1))
    moved = float(((momentum - momentum[0]).norm(dim=-1) / scale).max())
    if not moved < MOMENTUM_LIMIT:
        raise AssertionError(f"gravity run: momentum moved by {moved} of "
                             f"sum m|v|, limit {MOMENTUM_LIMIT}")
    print(f"  gravity run: {frames} frames of {n} bodies, {T} steps, wall "
          f"{wall:.3f} s (sync-closed), {n * n * T / wall / 1e9:.3f} G pair "
          f"interactions/s, momentum max |P_t - P_0| / sum m|v_t| = "
          f"{moved:.3e} (limit {MOMENTUM_LIMIT:g}), launches "
          f"{json.dumps(launches)}", flush=True)

    dense, large = GravitySim(n_balls=40), LargeNGravitySim(n_balls=40)
    state = tuple(a.to(dev) for a in
                  dense.init_state(torch.Generator().manual_seed(SEED)))
    want = dense.integrate(state, 300, freq)
    got = large.integrate(state, 300, freq)
    pos_err = float((got[0] - want[0]).abs().max())
    vel_err = float((got[1] - want[1]).abs().max())
    scale = float(want[0].abs().max())
    print(f"  large-N vs dense gravity, N=40 T=300: positions max_abs_err "
          f"{pos_err:.3e} (tolerance {SIM_POS_RTOL * scale:.3e}), velocities "
          f"{vel_err:.3e} (tolerance {SIM_VEL_ATOL:g})", flush=True)
    if pos_err > SIM_POS_RTOL * scale or vel_err > SIM_VEL_ATOL \
            or not torch.equal(got[3], want[3]):
        raise AssertionError("large-N and dense gravity disagree")
    return launches, wall


def committed_split(root=ROOT):
    """The directory of the committed charged-5 splits; raises when the
    checkout lacks one (the main paths run on them, nothing else)."""
    data_dir = root / "data"
    missing = [f"{k}_{split}_charged5_initvel1small.npy"
               for split in SPLITS for k in ("loc", "vel", "charges")
               if not (data_dir / f"{k}_{split}_charged5_initvel1small.npy")
               .is_file()]
    if missing:
        raise FileNotFoundError(
            f"the committed splits are incomplete in {data_dir}: missing "
            f"{', '.join(missing)}; chip_smoke.py runs from a checkout of "
            f"the repository with its data/ directory")
    return data_dir


def split_size(data_dir, split):
    return int(np.load(data_dir / f"loc_{split}_charged5_initvel1small.npy",
                       mmap_mode="r").shape[0])


def check_artifact(path, total, traj_len=TRAJ_LEN):
    """The test rollout's artifact has the shapes of ``total`` samples,
    ``traj_len`` windows of T=10 frames and the 40% horizon cut."""
    art = np.load(path)
    shapes = {"targets": (total, traj_len * 10, 5, 3),
              "preds": (total, int(0.4 * traj_len * 10), 5, 3),
              "energy_conservation": (total, int(0.4 * traj_len * 10), 1)}
    for key, shape in shapes.items():
        if art[key].shape != shape:
            raise AssertionError(f"{key} has shape {art[key].shape}, "
                                 f"expected {shape}")
    return art


def run_echoed(fn, *args):
    """Call fn with its standard output captured and echoed indented, the
    namespace dump left out. Returns (the printed lines, fn's result)."""
    import contextlib
    import io

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        result = fn(*args)
    lines = log.getvalue().splitlines()
    for line in lines:
        if not line.startswith("Namespace("):
            print(f"  | {line}", flush=True)
    return lines, result


def run_main_path(nt_main, kernels, data_dir, out_dir):
    from nonode_tpu_torch.analysis.registry import artifact_stem
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.models.egno import EGNO
    from nonode_tpu_torch.train.loop import EGNOExperiment

    args = nt_main.get_args([
        "--model", "egno", "--only_test", "true", "--device", "cuda",
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN),
        "--seed", str(SEED)])
    reset_launches(kernels)
    t0 = time.perf_counter()
    _, test_loss, _ = nt_main.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batches = split_size(data_dir, "test") // BATCH
    launches = read_launches(
        kernels, {"egnn_pairwise_fwd": LAYERS * TRAJ_LEN * batches},
        f"main path ({LAYERS} x {TRAJ_LEN} x {batches} forward, nothing else)")

    stem = artifact_stem("egno", "charged", SEED, 5)
    metrics = [json.loads(line) for line in
               (out_dir / args.exp_name / f"{stem}_metrics.jsonl")
               .read_text().splitlines()]
    art = check_artifact(out_dir / args.exp_name / f"{stem}_results.npz",
                         batches * BATCH)
    first = art["preds"][:BATCH, :20]
    if not np.isfinite(first).all():
        raise AssertionError("the first two windows of batch 0 are not finite")

    # the port's own CPU rollout of the same weights and batch
    t1 = time.perf_counter()
    cpu_model = EGNO(device="cpu",
                     generator=torch.Generator().manual_seed(SEED))
    cpu_ds = NBodyDataset(data_dir, partition="test", traj_len=2,
                          max_samples=BATCH, device="cpu")
    exp = EGNOExperiment(cpu_model)
    idx_np = exp.epoch_index_arrays(cpu_ds, np.random.RandomState(SEED))
    idx = {k: torch.from_numpy(v) for k, v in idx_np.items()}
    batch = exp._batch((cpu_ds.loc, cpu_ds.vel, cpu_ds.charges,
                        cpu_ds.edge_weights), idx, torch.arange(BATCH))
    cpu_pred, _ = exp.rollout(batch, 2, "charged")
    cpu_first = cpu_pred.transpose(0, 1).numpy()
    err = float(np.abs(first - cpu_first).max())
    scale = max(1.0, float(np.abs(cpu_first).max()))
    print(f"  card vs CPU rollout, batch 0 windows 0-1: max_abs_err "
          f"{err:.3e}, max|x| {scale:.3e} (tolerance {ROLLOUT_RTOL:g} x "
          f"max(1, max|x|)); CPU rollout {time.perf_counter() - t1:.1f} s",
          flush=True)
    if err > ROLLOUT_RTOL * scale:
        raise AssertionError(f"card and CPU rollouts disagree: {err}")
    print(f"  test_loss {test_loss} avg_num_steps "
          f"{metrics[-1]['avg_num_steps']} finite_fraction "
          f"{float(art['finite_fraction'])} main path wall {wall:.3f} s "
          f"launches {json.dumps(launches)}", flush=True)
    return launches


def run_train_path(nt_main, kernels, data_dir, out_dir):
    """``main --only_test false`` for two epochs: 2 x (train batches) x 4
    backward launches; the same forward launches plus (valid batches) x 4 at
    the epoch-1 validation and the test rollout's 4 x TRAJ_LEN x (test
    batches)."""
    from nonode_tpu_torch.analysis.registry import artifact_stem

    epochs = 2
    args = nt_main.get_args([
        "--model", "egno", "--only_test", "false", "--device", "cuda",
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--epochs", str(epochs), "--test_interval", "1",
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN),
        "--seed", str(SEED)])
    reset_launches(kernels)
    t0 = time.perf_counter()
    lines, (best_val, test_loss, best_epoch) = run_echoed(nt_main.main, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    train_b = min(args.max_samples, split_size(data_dir, "train")) // BATCH
    val_b = split_size(data_dir, "valid") // BATCH
    test_b = split_size(data_dir, "test") // BATCH
    bwd = epochs * train_b * LAYERS
    launches = read_launches(
        kernels, {"egnn_pairwise_fwd": bwd + val_b * LAYERS
                  + LAYERS * TRAJ_LEN * test_b, "egnn_pairwise_bwd": bwd},
        f"train path ({epochs} epochs x {train_b} batches x {LAYERS} layers "
        f"backward; as many forward plus {val_b} validation batches x "
        f"{LAYERS} and {LAYERS} x {TRAJ_LEN} x {test_b} in the test rollout)")

    stem = artifact_stem("egno", "charged", SEED, 5)
    run = out_dir / args.exp_name
    results = json.loads((run / f"{stem}.json").read_text())
    losses = results["train loss"] + results["val loss"]
    if (len(results["train loss"]) != epochs or results["eval epoch"] != [1]
            or not np.isfinite(losses).all() or best_epoch != 1
            or results["val loss"] != [best_val]):
        raise AssertionError(f"train path results {results}, best epoch "
                             f"{best_epoch}")
    ckpt = run / f"{stem}.ckpt"
    trained = [i for i, line in enumerate(lines)
               if line.startswith("training wall-clock")]
    loaded = [i for i, line in enumerate(lines)
              if line == f"Loading model from {ckpt}"]
    if not ckpt.is_file() or not trained or not loaded \
            or loaded[-1] < trained[-1]:
        raise AssertionError("the test rollout did not load the checkpoint "
                             "that training saved")
    check_artifact(run / f"{stem}_results.npz", test_b * BATCH)
    print(f"  train losses {results['train loss']} val loss {best_val} "
          f"test_loss {test_loss} train path wall {wall:.3f} s launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


def run_generate_and_gravity_main(nt_main, kernels, tmp):
    """The dataset writer on the card (small gravity splits: 30 frames, one
    test window of traj_len 2 from frame 0), its files' names, shapes and
    layouts, then ``main --dataset gravity --only_test false --epochs 1`` on
    them: one epoch of training (never validated, as the reference's
    ``epoch > 0`` gate), the test rollout of the trained weights."""
    from nonode_tpu_torch.analysis.registry import artifact_stem
    from nonode_tpu_torch.sim import generate

    data, n, length, traj_len = tmp / "gravity_data", 5, 3000, 2
    sizes = {"train": 512, "valid": 256, "test": 256}
    args = generate.get_args([
        "--simulation", "gravity", "--num-train", str(sizes["train"]),
        "--num-valid", str(sizes["valid"]), "--num-test", str(sizes["test"]),
        "--length", str(length), "--length_test", str(length),
        "--n_balls", str(n), "--suffix", "small", "--chunk", "512",
        "--seed", str(SEED), "--outdir", str(data)])
    reset_launches(kernels)
    t0 = time.perf_counter()
    run_echoed(generate.main, args)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = read_launches(kernels, {}, "generate (dense simulators, "
                                 "plain PyTorch)")
    frames = length // SAMPLE_FREQ
    for split, num in sizes.items():
        stem = f"{split}_gravity{n}_initvel1small.npy"
        for kind, shape in (("loc", (num, frames, n, 3)),
                            ("vel", (num, frames, n, 3)),
                            ("edges", (num, frames, n, 3)),      # forces
                            ("charges", (num, n, 1))):           # masses
            a = np.load(data / f"{kind}_{stem}")
            if a.shape != shape or a.dtype != np.float32 \
                    or not np.isfinite(a).all():
                raise AssertionError(f"{kind}_{stem}: {a.shape} {a.dtype}, "
                                     f"expected {shape} float32, finite")
        if not (np.load(data / f"charges_{stem}") > 0).all():
            raise AssertionError(f"charges_{stem}: masses must be positive")
    print(f"  generate: 12 files of {sum(sizes.values())} gravity "
          f"trajectories x {length} steps on the card in {gen_wall:.3f} s",
          flush=True)

    args = nt_main.get_args([
        "--model", "egno", "--dataset", "gravity", "--only_test", "false",
        "--epochs", "1", "--device", "cuda", "--data_dir", str(data),
        "--outf", str(tmp / "out"), "--batch_size", str(BATCH),
        "--traj_len", str(traj_len), "--seed", str(SEED)])
    reset_launches(kernels)
    t0 = time.perf_counter()
    _, (_, test_loss, _) = run_echoed(nt_main.main, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_b = sizes["train"] // BATCH
    test_b = sizes["test"] // BATCH
    launches = read_launches(
        kernels, {"egnn_pairwise_fwd": train_b * LAYERS
                  + LAYERS * traj_len * test_b,
                  "egnn_pairwise_bwd": train_b * LAYERS},
        f"gravity main (1 epoch x {train_b} batches x {LAYERS} layers "
        f"backward; as many forward and {LAYERS} x {traj_len} x {test_b} in "
        f"the test rollout)")
    stem = artifact_stem("egno", "gravity", SEED, n)
    results = json.loads((tmp / "out" / args.exp_name / f"{stem}.json")
                         .read_text())
    losses = results["train loss"] + results["test loss"]
    if len(results["train loss"]) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"gravity main results {results}")
    check_artifact(tmp / "out" / args.exp_name / f"{stem}_results.npz",
                   test_b * BATCH, traj_len)
    print(f"  gravity main: train loss {results['train loss']} test_loss "
          f"{test_loss} wall {wall:.3f} s launches {json.dumps(launches)}",
          flush=True)
    return gen_launches, launches


def check_train_step(data_dir, dev):
    """Loss and the gradient of every parameter on train batch 0 (the
    driver's seed-42 permutation) from the seed-42 weights, card against the
    port's CPU; then the median wall of one training step on the card,
    sync-closed, over the steps after the first."""
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.models.egno import EGNO
    from nonode_tpu_torch.train.loop import EGNOExperiment, make_perm

    runs = []
    for where in (dev, torch.device("cpu")):
        exp = EGNOExperiment(EGNO(device=where, generator=torch.Generator()
                                  .manual_seed(SEED)))
        ds = NBodyDataset(data_dir, partition="train", device=where)
        rng = np.random.RandomState(SEED)
        perm = make_perm(rng, len(ds), BATCH)
        idx_np = exp.epoch_index_arrays(ds, rng)
        idx = {k: torch.from_numpy(v).to(where) for k, v in idx_np.items()}
        batch = exp._batch((ds.loc, ds.vel, ds.charges, ds.edge_weights), idx,
                           torch.from_numpy(perm[0]).to(where))
        t0 = time.perf_counter()
        loss, _ = exp._loss(batch)
        loss.backward()
        loss = loss.detach()
        grads = {k: p.grad.detach().cpu() for k, p in
                 exp.model.named_parameters() if p.grad is not None}
        runs.append((loss.item(), grads, time.perf_counter() - t0,
                     (exp, ds, idx_np, perm)))
    (loss_c, g_c, _, card), (loss_h, g_h, cpu_s, _) = runs
    if set(g_c) != set(g_h) or len(g_c) < 40:
        raise AssertionError(f"parameters with a gradient differ: "
                             f"{sorted(set(g_c) ^ set(g_h))}")
    if abs(loss_c - loss_h) > GRAD_RTOL * max(1.0, abs(loss_h)):
        raise AssertionError(f"loss on the card {loss_c}, on the CPU {loss_h}")
    worst = (0.0, "")
    for name, gh in g_h.items():
        err = float((g_c[name] - gh).abs().max())
        scale = max(1.0, float(gh.abs().max()))
        if not torch.isfinite(g_c[name]).all() or err > GRAD_RTOL * scale:
            raise AssertionError(f"gradient of {name}: card vs CPU {err} > "
                                 f"{GRAD_RTOL} x {scale}")
        worst = max(worst, (err / scale, name))
    print(f"  train batch 0: loss card {loss_c!r} CPU {loss_h!r}; "
          f"{len(g_h)} parameter gradients, worst relative error "
          f"{worst[0]:.3e} ({worst[1]}; tolerance {GRAD_RTOL:g} x max(1, "
          f"max|g|) per tensor); CPU step {cpu_s:.1f} s", flush=True)

    exp, ds, idx_np, perm = card
    walls = []
    for b in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.train_epoch(ds, idx_np, perm[b:b + 1])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(walls[1:]))
    print(f"  training step wall (batch {BATCH}, sync-closed): median "
          f"{step_ms:.3f} ms over steps 2-6 "
          f"({', '.join(f'{1e3 * w:.3f}' for w in walls)} ms)", flush=True)
    return step_ms


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nonode_tpu_torch import main as nt_main
    from nonode_tpu_torch.ops.kernels import KERNELS, build, egnn_fused
    from nonode_tpu_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    data_dir = committed_split()
    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    phase("card", t0)

    t0 = time.perf_counter()
    sources = sorted({k["csrc"] for k in KERNELS})
    build.build_all(sources)
    for src in sources:
        for line in build.BUILD_LOGS.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src} ptxas: {line.strip()}", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    rows = {"egnn_pairwise_fwd": check_pairwise_kernel(egnn_fused, dev),
            "egnn_pairwise_bwd": check_pairwise_bwd_kernel(egnn_fused, dev),
            **check_nbody_kernels(dev)}
    check_fused_frames(dev)
    phase("kernels", t0)

    paths = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths["serving"] = run_main_path(nt_main, KERNELS, data_dir,
                                         Path(tmp) / "out")
    phase("main path", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths["train"] = run_train_path(nt_main, KERNELS, data_dir,
                                        Path(tmp) / "out")
    phase("train path", t0)

    t0 = time.perf_counter()
    check_train_step(data_dir, dev)
    phase("train step", t0)

    t0 = time.perf_counter()
    paths["stretch"], _ = run_stretch(KERNELS, dev)
    phase("stretch", t0)

    t0 = time.perf_counter()
    paths["gravity"], _ = run_gravity(KERNELS, dev)
    phase("gravity", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths["generate"], paths["gravity main"] = \
            run_generate_and_gravity_main(nt_main, KERNELS, Path(tmp))
    phase("generate", t0)

    # each kernel's launches on the path that runs it at full width
    own_path = {"egnn_pairwise_fwd": "train", "egnn_pairwise_bwd": "train",
                "nbody_charged_force": "stretch",
                "nbody_charged_leapfrog": "stretch",
                "nbody_gravity_accel": "gravity",
                "nbody_gravity_leapfrog": "gravity"}
    out = []
    for k in KERNELS:
        name = k["name"]
        out.append({"name": name, "route": k["route"],
                    "source": k["source"], "replaces": k["replaces"],
                    "status": "ported",
                    "launches": paths[own_path[name]][name],
                    "path": own_path[name],
                    "launches_by_path": {p: c[name] for p, c in paths.items()},
                    **rows[name]})
    print(json.dumps({"kernels": out}), flush=True)
    print(f"total: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
