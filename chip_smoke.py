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
   (a 99-step block, the drift, the record, the force kernel, the kick).
   #1 and #2 also run at SEGNO's shape (G=256, the per-edge clip engaged),
   timed, and at a G whose edge rows leave the last tile ragged (G=3);
   and with a seed axis, K=5 weight sets over G=5x2560 (EGNO) and G=5x256
   with the clip (SEGNO) in one launch: bitwise equal to 5 single-seed
   launches and over two runs, within 1e-4 x max(1, max|plain|) of the
   plain seed-axis version, timed beside the 5 single-seed launches;
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
7.-9. segno main path, segno train path, segno train step: phases 4-6 for
   ``--model segno`` at the model_confs.yaml:SEGNO width (hidden 64, T=10
   weight-tied steps, the per-edge clip): #1 launched once a step, 10 times
   a forward, #2 10 times a training step (``path_launches``); the rollout's
   artifact has one frame a window;
10.-11. egno fleet path, segno fleet path: ``python -m
   nonode_tpu_torch.fleet_main --seeds 1,2,3,4,5 --epochs 2
   --test_interval 1`` at the same widths on the committed splits: #1/#2
   launched as in one sequential run's training and validation (a fleet
   step launches each once a layer or integrator step for all five seeds),
   five test rollouts, five checkpoints and artifacts; each seed's epoch-1
   validation loss within 1e-3 relative of the sequential run of that seed
   on the card; a fleet step's wall and idle share beside five sequential
   steps';
12.-13. egno bf16 train path, segno bf16 train path: ``main --precision
   bf16 --only_test false --epochs 2``: no kernel in bf16 training and
   validation (the gate passes fp32 only), the fp32 test rollout on #1;
   losses finite and within rtol 0.2 of the fp32 train path of the same
   call; a bf16 step's wall beside fp32's;
14. stretch: the 1000-body charged run (as bench.py:bench_large_n),
   ``LargeNChargedSim(n_balls=1000)``, T=20000, sample_freq 100, from
   --seed 42: 199 finite frames, 1 launch of the force kernel (the kick
   before the loop) and 199 of the charged block kernel (a frame each), the
   energy drift in float64 under 5 x the
   first frame's kinetic energy (tests/test_large_sim.py:80-103); then the
   port's large-N and dense charged simulators from one state (N=20,
   T=300) on the card;
15. gravity: ``LargeNGravitySim(n_balls=1000)``, T=2000, sample_freq 100:
   20 launches of the gravity block kernel and 1 of the gravity kernel,
   total momentum conserved; then large-N against dense (N=40, T=300);
16. generate: ``python -m nonode_tpu_torch.sim.generate --simulation gravity``
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
# frames a window decodes (EGNO) and integrator steps a forward (SEGNO):
# model_confs.yaml's num_timesteps for both
T_MODEL = 10
# what a driver run of each model must show: launches of #1 a model forward
# (EGNO: one a layer; SEGNO: one an integrator step), frames a test window
# predicts (EGNO decodes T; SEGNO steps T ahead to one frame) and the share
# of the horizon its artifact keeps; the parameters a training step must give
# a gradient (EGNO's last node MLP feeds no loss term; each of SEGNO's 14 is
# used by all T weight-tied steps)
EXPECT = {"egno": dict(per_forward=LAYERS, window_frames=T_MODEL, cut=0.4,
                       grads=40),
          "segno": dict(per_forward=T_MODEL, window_frames=1, cut=1.0,
                        grads=14)}
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


# #1/#2 cases: (label, shape and inputs, clip_edges, the row it times or
# None). The EGNO slice shape first (held to the split-TF32 budget), then
# SEGNO's: G = its batch, the clip engaged; a G whose 25 G edge rows leave the
# last 128-row tile ragged; the mocap-like sparse graph.
PAIRWISE_CASES = [
    ("slice G=2560 N=5 H=64 E=2", dict(g=2560, n=5), False, "slice"),
    ("clip_edges=True", dict(g=2560, n=5, coord_scale=400.0), True, None),
    ("SEGNO G=256 N=5 H=64 E=2 clip_edges=True",
     dict(g=256, n=5, coord_scale=400.0), True, "segno"),
    ("ragged G=3 clip_edges=True", dict(g=3, n=5, coord_scale=400.0), True,
     "ragged"),
    ("2-D edge_mask N=31 (mocap)", dict(g=256, n=31, isolated=3), False,
     None),
]


def check_pairwise_kernel(egnn_fused, dev):
    """Kernel vs plain version in PAIRWISE_CASES; returns the timed rows
    ({"slice": ..., "segno": ..., "ragged": ...})."""
    rows = {}
    for label, kw, clip, timed in PAIRWISE_CASES:
        kw = dict(kw)
        g, n = kw.pop("g"), kw.pop("n")
        args = pairwise_inputs(g, n, 64, 2, seed=n, dev=dev, **kw)
        with torch.no_grad():
            got = egnn_fused.pairwise_message(clip, *args)
            again = egnn_fused.pairwise_message(clip, *args)
            torch.cuda.synchronize()
            want = egnn_fused.pairwise_message_reference(clip, *args)
        if clip:
            free = egnn_fused.pairwise_message_reference(False, *args)[0]
            if float((free - want[0]).abs().max()) <= 1e-3:
                raise AssertionError(f"{label}: the clip never engaged")
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
            if timed == "slice" and err > SPLIT_TF32_RTOL * scale:
                raise AssertionError(f"{label}: {name} relative error "
                                     f"{err / scale} over the split-TF32 "
                                     f"budget {SPLIT_TF32_RTOL}")
            errs.append(err)
        if timed is None:
            continue
        with torch.no_grad():
            ms = device_ms(lambda: egnn_fused.pairwise_message(clip, *args))
            plain_ms = device_ms(
                lambda: egnn_fused.pairwise_message_reference(clip, *args))
        fp32 = pairwise_bound_ms(g, args[4], 64, 2)
        tc = pairwise_tc_bound_ms(g, args[4], 64, 2)
        kept = g * int((args[4] != 0).sum())
        print(f"  {label}: kernel {ms:.4f} ms, plain version {plain_ms:.4f} "
              f"ms (no yardstick), {bounds_text(fp32, tc, ms)}, over the "
              f"{kept} edges the mask keeps; the kernel also computes the "
              f"{g * n * n - kept} masked-out edge rows; no single PyTorch "
              f"call computes this function"
              + (f"; slice-shape relative error within {SPLIT_TF32_RTOL:g}"
                 if timed == "slice" else ""), flush=True)
        rows[timed] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           library_ms=None, **route_row(ms, fp32, tc))
    return rows


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
    twice and held bitwise equal; returns the timed rows."""
    rows = {}
    for label, kw, clip, timed in PAIRWISE_CASES:
        kw = dict(kw)
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
            if timed == "slice" and err > SPLIT_TF32_RTOL * scale:
                raise AssertionError(f"{label}: {name} relative error "
                                     f"{err / scale} over the split-TF32 "
                                     f"budget {SPLIT_TF32_RTOL}")
            errs.append(err)
            worst = max(worst, (err / scale, name))
        print(f"  {label}: backward max_abs_err {max(errs):.3e}, worst "
              f"relative {worst[0]:.3e} ({worst[1]}; tolerance "
              f"{KERNEL_RTOL:g} x max(1, max|plain|) per output); two runs "
              f"bitwise equal", flush=True)
        if timed is None:
            continue
        ms = device_ms(lambda: egnn_fused.pairwise_message_bwd(
            clip, *args, *cot))
        plain_ms = device_ms(
            lambda: egnn_fused.pairwise_message_bwd_reference(
                clip, *args, *cot))
        fp32 = pairwise_bwd_bound_ms(g, args[4], 64, 2)
        tc = pairwise_tc_bound_ms(g, args[4], 64, 2, backward=True)
        print(f"  {label}: backward kernel {ms:.4f} ms (both launches), "
              f"plain version {plain_ms:.4f} ms (no yardstick), "
              f"{bounds_text(fp32, tc, ms)}; no single PyTorch call "
              f"computes this function"
              + (f"; slice-shape relative error within {SPLIT_TF32_RTOL:g}"
                 if timed == "slice" else ""), flush=True)
        rows[timed] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           library_ms=None, **route_row(ms, fp32, tc))
    return rows


# seed-axis cases of #1/#2 (seed fleets): K weight sets over G = K x B
# graphs at EGNO's and SEGNO's shapes; (label, B, clip_edges, coord_scale)
SEEDS = 5
SEED_AXIS_CASES = [
    ("egno", 2560, False, 1.0),
    ("segno", 256, True, 400.0),
]


def seed_axis_inputs(k, b, n, h, e, seed, dev, coord_scale):
    """Inputs of G = k x b graphs and k stacked weight sets (each as
    pairwise_inputs draws one, from seeds seed .. seed + k - 1)."""
    x, hi, hj, efea, mask, _ = pairwise_inputs(k * b, n, h, e, seed, dev)
    sets = [pairwise_inputs(1, n, h, e, seed + 1 + s, dev,
                            coord_scale=coord_scale)[5] for s in range(k)]
    weights = tuple(torch.stack(ws) for ws in zip(*sets))
    return x, hi, hj, efea, mask, weights, sets


def check_seed_axis_kernels(egnn_fused, dev):
    """#1 and #2 with SEEDS weight sets in one launch, at EGNO's and SEGNO's
    shapes: bitwise equal to one launch per seed, within KERNEL_RTOL x
    max(1, max|plain|) of the plain seed-axis version, bitwise repeatable;
    timed beside the SEEDS single-seed launches, with SEEDS times the
    single-seed split-TF32 bound. Returns {"egnn_pairwise_fwd": {label:
    row}, "egnn_pairwise_bwd": {...}}."""
    k, n, h, e = SEEDS, 5, 64, 2
    rows = {"egnn_pairwise_fwd": {}, "egnn_pairwise_bwd": {}}
    for label, b, clip, coord_scale in SEED_AXIS_CASES:
        x, hi, hj, efea, mask, weights, sets = seed_axis_inputs(
            k, b, n, h, e, 11, dev, coord_scale)
        part = lambda t, s: t[s * b:(s + 1) * b]          # noqa: E731
        rng = np.random.RandomState(b)
        cot = tuple(torch.tensor(rng.randn(*shape), dtype=torch.float32,
                                 device=dev)
                    for shape in ((k * b, n, 3), (k * b, n, h)))
        args = (x, hi, hj, efea, mask, weights)
        with torch.no_grad():
            fwd = lambda: egnn_fused.pairwise_message(clip, *args)  # noqa: E731
            got, again = fwd(), fwd()
            single = lambda: [egnn_fused.pairwise_message(  # noqa: E731
                clip, *(part(t, s) for t in (x, hi, hj, efea)), mask,
                sets[s]) for s in range(k)]
            ones = single()
            torch.cuda.synchronize()
            want = egnn_fused.pairwise_message_seeds_reference(clip, *args)
        bwd = lambda: egnn_fused.pairwise_message_bwd(clip, *args, *cot)  # noqa: E731
        bsingle = lambda: [egnn_fused.pairwise_message_bwd(  # noqa: E731
            clip, *(part(t, s) for t in (x, hi, hj, efea)), mask, sets[s],
            *(part(c, s) for c in cot)) for s in range(k)]
        bgot, bagain, bones = bwd_outputs(bwd()), bwd_outputs(bwd()), \
            [bwd_outputs(o) for o in bsingle()]
        torch.cuda.synchronize()
        bwant = bwd_outputs(egnn_fused.pairwise_message_bwd_seeds_reference(
            clip, *args, *cot))
        if clip:
            free = egnn_fused.pairwise_message_seeds_reference(False, *args)
            if float((free[0] - want[0]).abs().max()) <= 1e-3:
                raise AssertionError(f"seed axis {label}: the clip never "
                                     f"engaged")
        per_seed = {"tot_f": torch.cat([o[0] for o in ones]),
                    "tot_m": torch.cat([o[1] for o in ones])}
        for name in bgot:
            cat = torch.stack if name.startswith("d") and name not in (
                "dx", "dhi", "dhj", "defea") else torch.cat
            per_seed[name] = cat([o[name] for o in bones])
        outs = {**dict(zip(("tot_f", "tot_m"), got)), **bgot}
        twice = {**dict(zip(("tot_f", "tot_m"), again)), **bagain}
        plain = {**dict(zip(("tot_f", "tot_m"), want)), **bwant}
        errs = {"egnn_pairwise_fwd": [], "egnn_pairwise_bwd": []}
        for name, a in outs.items():
            which = "egnn_pairwise_fwd" if name.startswith("tot") \
                else "egnn_pairwise_bwd"
            if a.shape != plain[name].shape or not torch.isfinite(a).all():
                raise AssertionError(f"seed axis {label}: {name} has shape "
                                     f"{tuple(a.shape)} or is not finite")
            if not torch.equal(a, per_seed[name]):
                diff = float((a - per_seed[name]).abs().max())
                raise AssertionError(f"seed axis {label}: {name} differs "
                                     f"from {k} single-seed launches by "
                                     f"{diff}")
            if not torch.equal(a, twice[name]):
                raise AssertionError(f"seed axis {label}: {name} differs "
                                     f"between two runs")
            err = float((a - plain[name]).abs().max())
            scale = max(1.0, float(plain[name].abs().max()))
            if err > KERNEL_RTOL * scale:
                raise AssertionError(f"seed axis {label}: {name} disagrees "
                                     f"with the plain seed-axis version: "
                                     f"{err} > {KERNEL_RTOL} x {scale}")
            errs[which].append(err / scale)
        timing = {
            "egnn_pairwise_fwd": (fwd, single, lambda: egnn_fused.
                                  pairwise_message_seeds_reference(
                                      clip, *args)),
            "egnn_pairwise_bwd": (bwd, bsingle, lambda: egnn_fused.
                                  pairwise_message_bwd_seeds_reference(
                                      clip, *args, *cot))}
        for which, (fn, fn_k, fn_plain) in timing.items():
            backward = which == "egnn_pairwise_bwd"
            with torch.no_grad():
                ms, k_ms, plain_ms = (device_ms(f) for f in
                                      (fn, fn_k, fn_plain))
            one_tc = pairwise_tc_bound_ms(b, mask, h, e, backward)
            one_fp32 = (pairwise_bwd_bound_ms if backward
                        else pairwise_bound_ms)(b, mask, h, e)
            tc, fp32 = (k * one_tc[0], one_tc[1]), (k * one_fp32[0],
                                                     one_fp32[1])
            print(f"  seed axis {label} K={k} G={k}x{b}"
                  f"{' clip_edges=True' if clip else ''}: "
                  f"{'backward' if backward else 'forward'} one launch "
                  f"{ms:.4f} ms, {k} single-seed launches {k_ms:.4f} ms, "
                  f"plain seed-axis version {plain_ms:.4f} ms; worst "
                  f"relative error {max(errs[which]):.3e} against the plain "
                  f"version (tolerance {KERNEL_RTOL:g}); bitwise equal to "
                  f"the {k} single-seed launches and over two runs; "
                  f"{bounds_text(fp32, tc, ms)} ({k} x one seed's)",
                  flush=True)
            rows[which][label] = dict(
                seeds=k, graphs_per_seed=b, max_rel_err=max(errs[which]),
                ms=ms, single_seed_launches_ms=k_ms, plain_ms=plain_ms,
                library_ms=None, **route_row(ms, fp32, tc))
    return rows


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


def path_launches(per_forward, test_batches, traj_len, epochs=0,
                  train_batches=0, validations=0, val_batches=0):
    """Launches of #1 and #2 on a driver run: a model forward launches #1
    ``per_forward`` times (EGNO: once a layer; SEGNO: once an integrator
    step) and a training step's backward #2 as often; training runs
    ``epochs`` x ``train_batches`` steps, each validation ``val_batches``
    forwards, and the test rollout ``traj_len`` windows of one forward a
    test batch."""
    bwd = epochs * train_batches * per_forward
    fwd = (bwd + validations * val_batches * per_forward
           + test_batches * traj_len * per_forward)
    return {"egnn_pairwise_fwd": fwd, "egnn_pairwise_bwd": bwd}


def check_artifact(path, total, traj_len=TRAJ_LEN, model="egno"):
    """The test rollout's artifact has the shapes of ``total`` samples and
    ``traj_len`` windows (``EXPECT``): EGNO's of T=10 frames each, cut at
    40% of the horizon; SEGNO's of one frame each, not cut."""
    art = np.load(path)
    spec = EXPECT[model]
    full = traj_len * spec["window_frames"]
    cut = int(spec["cut"] * traj_len * spec["window_frames"])
    shapes = {"targets": (total, full, 5, 3),
              "preds": (total, cut, 5, 3),
              "energy_conservation": (total, cut, 1)}
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


def seed_experiment(nt_main, model, where, seed=SEED, extra=()):
    """The driver's experiment of ``model`` with the ``seed`` weights on
    ``where``, as ``main`` builds it (``extra``: more driver flags)."""
    from nonode_tpu_torch.runtime import seed_everything

    args = nt_main.get_args(["--model", model, "--seed", str(seed), *extra])
    return nt_main.build_experiment(args, torch.device(where),
                                    seed_everything(seed))


def cpu_first_windows(nt_main, model, data_dir):
    """The port's own CPU rollout of the seed-42 weights over the first two
    windows of test batch 0, as [BATCH, frames, N, 3]: the windows that the
    test rollout draws from a fresh seed-42 RandomState."""
    from nonode_tpu_torch.data.nbody import NBodyDataset

    exp = seed_experiment(nt_main, model, "cpu")
    ds = NBodyDataset(data_dir, partition="test", traj_len=2,
                      max_samples=BATCH, device="cpu")
    perm, windows = exp.draw_epoch(ds, np.random.RandomState(SEED), BATCH,
                                   shuffle=False)
    pred, _ = exp.rollout(exp.batch(ds, windows, 0, torch.from_numpy(perm[0])),
                          2, "charged")
    return pred.transpose(0, 1).numpy()


def run_main_path(nt_main, kernels, data_dir, out_dir, model="egno"):
    """``main --only_test true``: the test rollout of the seed-42 weights on
    the committed test split, #1 only; the first two windows of batch 0
    against the port's CPU rollout."""
    from nonode_tpu_torch.analysis.registry import artifact_stem

    args = nt_main.get_args([
        "--model", model, "--only_test", "true", "--device", "cuda",
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN),
        "--seed", str(SEED)])
    reset_launches(kernels)
    t0 = time.perf_counter()
    _, test_loss, _ = nt_main.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batches = split_size(data_dir, "test") // BATCH
    per_forward = EXPECT[model]["per_forward"]
    launches = read_launches(
        kernels, path_launches(per_forward, batches, TRAJ_LEN),
        f"{model} main path ({per_forward} x {TRAJ_LEN} x {batches} "
        f"forward, nothing else)")

    stem = artifact_stem(model, "charged", SEED, 5)
    metrics = [json.loads(line) for line in
               (out_dir / args.exp_name / f"{stem}_metrics.jsonl")
               .read_text().splitlines()]
    art = check_artifact(out_dir / args.exp_name / f"{stem}_results.npz",
                         batches * BATCH, model=model)
    first = art["preds"][:BATCH, :2 * EXPECT[model]["window_frames"]]
    if not np.isfinite(first).all():
        raise AssertionError("the first two windows of batch 0 are not finite")

    t1 = time.perf_counter()
    cpu_first = cpu_first_windows(nt_main, model, data_dir)
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


def run_train_path(nt_main, kernels, data_dir, out_dir, model="egno"):
    """``main --only_test false`` for two epochs: training, the validation
    at epoch 1, the best checkpoint saved and reloaded, the test rollout
    (``path_launches``)."""
    from nonode_tpu_torch.analysis.registry import artifact_stem

    epochs = 2
    args = nt_main.get_args([
        "--model", model, "--only_test", "false", "--device", "cuda",
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
    per_forward = EXPECT[model]["per_forward"]
    launches = read_launches(
        kernels, path_launches(per_forward, test_b, TRAJ_LEN, epochs,
                               train_b, 1, val_b),
        f"{model} train path ({epochs} epochs x {train_b} batches x "
        f"{per_forward} backward; as many forward plus {val_b} validation "
        f"batches x {per_forward} and {per_forward} x {TRAJ_LEN} x {test_b} "
        f"in the test rollout)")

    stem = artifact_stem(model, "charged", SEED, 5)
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
    check_artifact(run / f"{stem}_results.npz", test_b * BATCH, model=model)
    print(f"  train losses {results['train loss']} val loss {best_val} "
          f"test_loss {test_loss} train path wall {wall:.3f} s launches "
          f"{json.dumps(launches)}", flush=True)
    return launches, results


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
        kernels, path_launches(LAYERS, test_b, traj_len, 1, train_b),
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


def train_batch0(nt_main, model, where, data_dir, extra=()):
    """The seed-42 weights on ``where`` and train batch 0 of the driver's
    first epoch (its seed-42 permutation and windows). Returns (experiment,
    a function that computes batch 0's loss, a function that runs one
    training step on batch b: one input, so every batch has batch 0's
    windows)."""
    from nonode_tpu_torch.data.nbody import NBodyDataset

    exp = seed_experiment(nt_main, model, where, extra=extra)
    ds = NBodyDataset(data_dir, partition="train", device=where)
    perm, windows = exp.draw_epoch(ds, np.random.RandomState(SEED), BATCH)
    idx0 = torch.from_numpy(perm[0]).to(where)
    return (exp, lambda: exp._loss(exp.batch(ds, windows, 0, idx0))[0],
            lambda b: exp.train_epoch(ds, windows, perm[b:b + 1]))


def check_train_step(nt_main, data_dir, dev, model="egno"):
    """Loss and the gradient of every parameter on train batch 0 (the
    driver's seed-42 permutation) from the seed-42 weights, card against the
    port's CPU, with at least ``EXPECT``'s count of parameters given a
    gradient; then the median wall of one training step on the card,
    sync-closed, over the steps after the first."""
    runs = []
    for where in (dev, torch.device("cpu")):
        exp, loss_fn, step = train_batch0(nt_main, model, where, data_dir)
        t0 = time.perf_counter()
        loss = loss_fn()
        loss.backward()
        loss = loss.detach()
        grads = {k: p.grad.detach().cpu() for k, p in
                 exp.model.named_parameters() if p.grad is not None}
        runs.append((loss.item(), grads, time.perf_counter() - t0, step))
    (loss_c, g_c, _, card_step), (loss_h, g_h, cpu_s, _) = runs
    least = EXPECT[model]["grads"]
    if set(g_c) != set(g_h) or len(g_c) < least:
        raise AssertionError(f"parameters with a gradient differ: "
                             f"{sorted(set(g_c) ^ set(g_h))}, {len(g_c)} of "
                             f"at least {least}")
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
    print(f"  {model} train batch 0: loss card {loss_c!r} CPU {loss_h!r}; "
          f"{len(g_h)} parameter gradients, worst relative error "
          f"{worst[0]:.3e} ({worst[1]}; tolerance {GRAD_RTOL:g} x max(1, "
          f"max|g|) per tensor); CPU step {cpu_s:.1f} s", flush=True)

    walls = []
    for b in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_step(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(walls[1:]))
    print(f"  {model} training step wall (batch {BATCH}, sync-closed): median "
          f"{step_ms:.3f} ms over steps 2-6 "
          f"({', '.join(f'{1e3 * w:.3f}' for w in walls)} ms)", flush=True)
    return step_ms


def median_step_ms(step, steps=6):
    """Median sync-closed wall of ``step(b)`` over b = 1 .. steps - 1 (the
    first is a warm-up)."""
    walls = []
    for b in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(walls[1:]))


def traced(fn):
    """(wall s, device kernel ms, kernel launches, idle share) of ``fn``
    under torch.profiler, as scripts/profile_torch_training.py counts them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) ==
              torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events)
    if not events:
        raise AssertionError("the profiler saw no device time")
    return (wall, device_us / 1e3, sum(e.count for e in events),
            1 - device_us / 1e6 / wall)


FLEET_SEEDS = (1, 2, 3, 4, 5)
# a fleet's epoch-1 validation loss against the sequential run of the same
# seed on the card: the same fp32 arithmetic batched over the seeds (other
# GEMM shapes, the seed-axis kernels bitwise as single-seed launches)
# through 22 Adam steps
FLEET_RTOL = 1e-3


def run_fleet_path(nt_main, kernels, data_dir, out_dir, dev,
                   model="egno"):
    """``fleet_main --seeds 1,2,3,4,5 --epochs 2 --test_interval 1`` at full
    width on the committed splits: #1/#2 launch as in ONE sequential run's
    training and validation (once a layer or integrator step for all five
    seeds), plus five test rollouts; five per-seed checkpoints and
    artifacts; each seed's epoch-1 validation loss within FLEET_RTOL of the
    sequential run of that seed on the card. Then a fleet step's wall and
    idle share beside five sequential steps' in this call."""
    from nonode_tpu_torch import fleet_main
    from nonode_tpu_torch.analysis.registry import artifact_stem
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.parallel.fleet import SeedFleet

    k, epochs = len(FLEET_SEEDS), 2
    args = fleet_main.get_args([
        "--model", model, "--seeds", ",".join(map(str, FLEET_SEEDS)),
        "--epochs", str(epochs), "--test_interval", "1", "--device", dev.type,
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN)])
    reset_launches(kernels)
    t0 = time.perf_counter()
    lines, records = run_echoed(fleet_main.main, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_b = min(args.max_samples, split_size(data_dir, "train")) // BATCH
    val_b = split_size(data_dir, "valid") // BATCH
    test_b = split_size(data_dir, "test") // BATCH
    pf = EXPECT[model]["per_forward"]
    want = path_launches(pf, 0, 0, epochs, train_b, 1, val_b)
    want["egnn_pairwise_fwd"] += k * test_b * TRAJ_LEN * pf
    launches = read_launches(
        kernels, want,
        f"{model} fleet path ({epochs} epochs x {train_b} fleet steps x "
        f"{pf}, for all {k} seeds; {val_b} validation batches x {pf}; "
        f"{k} test rollouts of {pf} x {TRAJ_LEN} x {test_b})")
    train_wall = [float(line.split(": ")[1].split("s ")[0]) for line in lines
                  if line.startswith("fleet training wall-clock")][0]
    run = out_dir / args.exp_name
    for rec in records:
        stem = artifact_stem(model, "charged", rec["seed"], 5)
        # (the test loss of random-weight EGNO rollouts may be nan, as the
        # sequential driver's: their windows diverge)
        if not (run / f"{stem}.ckpt").is_file() \
                or not np.isfinite(rec["best_val_loss"]) \
                or rec["best_epoch"] != 1:
            raise AssertionError(f"fleet record {rec}")
        check_artifact(run / f"{stem}_results.npz", test_b * BATCH,
                       model=model)

    # the sequential runs of the same seeds on the card, to epoch 1's
    # validation, and the walls of their steps
    ds = NBodyDataset(data_dir, partition="train", device=dev)
    ds_val = NBodyDataset(data_dir, partition="val", device=dev)
    seq_step_ms, worst = [], 0.0
    for rec in records:
        seed = rec["seed"]
        exp = seed_experiment(nt_main, model, dev, seed=seed)
        rng = np.random.RandomState(seed)
        for epoch in range(epochs):
            perm, windows = exp.draw_epoch(ds, rng, BATCH)
            exp.train_epoch(ds, windows, perm)
        perm, windows = exp.draw_epoch(ds_val, rng, BATCH, shuffle=False)
        val = float(exp.eval_epoch(ds_val, windows, perm)[1].mean())
        rel = abs(rec["best_val_loss"] - val) / max(abs(val), 1e-30)
        worst = max(worst, rel)
        if rel > FLEET_RTOL:
            raise AssertionError(f"seed {seed}: fleet epoch-1 validation "
                                 f"loss {rec['best_val_loss']}, sequential "
                                 f"{val}")
        perm, windows = exp.draw_epoch(ds, rng, BATCH)
        seq_step_ms.append(median_step_ms(
            lambda b: exp.train_epoch(ds, windows, perm[b % len(perm)][None])))
    seq_trace = traced(lambda: exp.train_epoch(ds, windows, perm[:2]))

    # a fleet step: its launches of #1/#2, wall and idle share
    build = fleet_main.build_experiment
    fargs = nt_main.get_args(["--model", model])
    fexp = seed_experiment(nt_main, model, dev, seed=FLEET_SEEDS[0])
    fleet = SeedFleet(fexp, FLEET_SEEDS)
    params, opt = fleet.init(lambda g: build(fargs, dev,
                                             g).model)
    perms = fleet.make_perms([np.random.RandomState(s) for s in FLEET_SEEDS],
                             len(ds), BATCH)
    fwin = fexp.windows(ds, None, perms.shape[1])
    step = lambda b: fleet.train_epoch(  # noqa: E731
        params, opt, ds, fwin, perms[:, b % perms.shape[1]][:, None])
    step(0)
    torch.cuda.synchronize()
    reset_launches(kernels)
    step(1)
    torch.cuda.synchronize()
    read_launches(kernels, {"egnn_pairwise_fwd": pf,
                            "egnn_pairwise_bwd": pf},
                  f"{model} fleet step ({pf} of each for all {k} seeds, as "
                  f"one sequential step)")
    fleet_ms = median_step_ms(step)
    f_trace = traced(lambda: [step(2), step(3)])
    seq_k = float(np.sum(seq_step_ms))
    print(f"  {model} fleet of {k} seeds: fleet_main wall {wall:.3f} s "
          f"(training {train_wall} s); epoch-1 validation losses "
          f"{[r['best_val_loss'] for r in records]}, worst relative "
          f"difference from the sequential runs {worst:.3e} (tolerance "
          f"{FLEET_RTOL:g}); fleet step {fleet_ms:.3f} ms against {k} "
          f"sequential steps {seq_k:.3f} ms ({', '.join(f'{m:.3f}' for m in seq_step_ms)}"
          f"), {seq_k / fleet_ms:.2f}x; traced over 2 steps: fleet wall "
          f"{1e3 * f_trace[0]:.3f} ms, device {f_trace[1]:.3f} ms over "
          f"{f_trace[2]} launches, idle share {f_trace[3]:.4f}; one seed "
          f"sequential wall {1e3 * seq_trace[0]:.3f} ms, device "
          f"{seq_trace[1]:.3f} ms over {seq_trace[2]} launches, idle share "
          f"{seq_trace[3]:.4f}; launches {json.dumps(launches)}", flush=True)
    return launches


BF16_RTOL = 0.2     # bf16 against fp32 losses (tests/test_driver.py:135-145)


def run_bf16_path(nt_main, kernels, data_dir, out_dir, dev, fp32,
                  fp32_step_ms, model="egno"):
    """``main --precision bf16 --only_test false --epochs 2``: the bf16
    forward and backward take the dense chain (the kernel gate passes fp32
    only), so #1/#2 launch only in the test rollout, which stays fp32;
    finite losses within BF16_RTOL of the fp32 train path of this call
    (``fp32``, its results); a bf16 step's wall beside the fp32 step's."""
    from nonode_tpu_torch.analysis.registry import artifact_stem

    args = nt_main.get_args([
        "--model", model, "--only_test", "false", "--device", dev.type,
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--epochs", "2", "--test_interval", "1", "--precision", "bf16",
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN),
        "--seed", str(SEED)])
    reset_launches(kernels)
    t0 = time.perf_counter()
    _, (best_val, test_loss, _) = run_echoed(nt_main.main, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    test_b = split_size(data_dir, "test") // BATCH
    launches = read_launches(
        kernels, path_launches(EXPECT[model]["per_forward"], test_b,
                               TRAJ_LEN),
        f"{model} bf16 train path (no kernel in bf16 training and "
        f"validation; the fp32 test rollout)")
    stem = artifact_stem(model, "charged", SEED, 5)
    results = json.loads((out_dir / args.exp_name / f"{stem}.json")
                         .read_text())
    for key in ("train loss", "val loss"):
        got, ref = np.asarray(results[key]), np.asarray(fp32[key])
        if not np.isfinite(got).all() or not np.allclose(
                got, ref, rtol=BF16_RTOL, atol=0):
            raise AssertionError(f"{model} bf16 {key} {got.tolist()}, fp32 "
                                 f"{ref.tolist()} (rtol {BF16_RTOL})")
    _, _, step = train_batch0(nt_main, model, dev, data_dir,
                              extra=("--precision", "bf16"))
    bf16_ms = median_step_ms(step)
    print(f"  {model} bf16: train losses {results['train loss']} val loss "
          f"{best_val} (fp32 {fp32['train loss']} {fp32['val loss']}; "
          f"rtol {BF16_RTOL}) test_loss {test_loss} train path wall "
          f"{wall:.3f} s; bf16 step {bf16_ms:.3f} ms against fp32 "
          f"{fp32_step_ms:.3f} ms ({bf16_ms / fp32_step_ms:.2f}x; no speed "
          f"claim); launches {json.dumps(launches)}", flush=True)
    return launches


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
    pair_rows = {"egnn_pairwise_fwd": check_pairwise_kernel(egnn_fused, dev),
                 "egnn_pairwise_bwd": check_pairwise_bwd_kernel(egnn_fused,
                                                                dev)}
    seed_rows = check_seed_axis_kernels(egnn_fused, dev)
    rows = {name: dict(r["slice"], segno_shape=r["segno"],
                       ragged_shape=r["ragged"], seed_axis=seed_rows[name])
            for name, r in pair_rows.items()}
    rows.update(check_nbody_kernels(dev))
    check_fused_frames(dev)
    phase("kernels", t0)

    paths = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths["serving"] = run_main_path(nt_main, KERNELS, data_dir,
                                         Path(tmp) / "out")
    phase("main path", t0)

    fp32_runs = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths["train"], fp32_runs["egno"] = run_train_path(
            nt_main, KERNELS, data_dir, Path(tmp) / "out")
    phase("train path", t0)

    t0 = time.perf_counter()
    step_ms = {"egno": check_train_step(nt_main, data_dir, dev)}
    phase("train step", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths["segno serving"] = run_main_path(
            nt_main, KERNELS, data_dir, Path(tmp) / "out", model="segno")
    phase("segno main path", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths["segno train"], fp32_runs["segno"] = run_train_path(
            nt_main, KERNELS, data_dir, Path(tmp) / "out", model="segno")
    phase("segno train path", t0)

    t0 = time.perf_counter()
    step_ms["segno"] = check_train_step(nt_main, data_dir, dev,
                                        model="segno")
    phase("segno train step", t0)

    for model in ("egno", "segno"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            paths[f"{model} fleet"] = run_fleet_path(
                nt_main, KERNELS, data_dir, Path(tmp) / "out", dev, model)
        phase(f"{model} fleet path", t0)

    for model in ("egno", "segno"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            paths[f"{model} bf16 train"] = run_bf16_path(
                nt_main, KERNELS, data_dir, Path(tmp) / "out", dev,
                fp32_runs[model], step_ms[model], model)
        phase(f"{model} bf16 train path", t0)

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
