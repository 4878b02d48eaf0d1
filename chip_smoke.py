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
   plain seed-axis version, timed beside the 5 single-seed launches.
   #1 and #2 at H=128 (their second width, weights read from global
   memory) at the mocap path's shape: G=60, N=31, E=1 on the written
   skeleton's skeleton + 2-hop mask, without and with the clip, and K=2
   weight sets over G = 2 x 30; each against its plain version, twice
   bitwise equal, timed beside its bound. #1 and #2 on receiver slices
   (the particle axis over --space): N=10 in two slices of 5 receivers at
   G=50 (with and without the clip) and G=500; the whole-graph launch,
   (0, N), bitwise the H=64-only build (a sha256 of its outputs, on 132
   SMs) and the launch without a slice; the slices' tot_f, tot_m, dhi and
   defea side by side bitwise the whole launch's, their dx, dhj and weight
   gradients summed within 1e-5 of it; each slice against its plain
   version and timed beside its bound. #1 and #2 at widths they are not
   built for, H=32, 96 and 100, zero-padded to 64 or 128 in the wrappers:
   at EGNO's serving shape within the split-TF32 budget of the slice
   shape, with the clip engaged, and with two weight sets over G = 2 x
   1280; each against its plain version at the native width, timed beside
   its bound at that width and at the padded one, and beside H=128 at
   EGNO's shape;
4. main path: ``nonode_tpu_torch.main --model egno --only_test true`` on the
   committed charged-5 test split at the canonical EGNO width (4 layers,
   hidden 64, T=10, batch 256, traj_len 20), weights from --seed 42. Checks
   the artifact's shapes, the kernel launch counts, and the first two windows
   of batch 0 against the port's own CPU rollout of the same weights;
5. train path: ``main --model egno --only_test false --epochs 2
   --test_interval 1`` at the same width on the committed train, valid and
   test splits: training, validation at epoch 1, the best checkpoint saved
   and reloaded, the test rollout. Checks the launch counts of both kernels,
   finite losses, the checkpoint and the artifact; prints the run's wall
   broken down by the port's PhaseTimer (the model and optimizer builds,
   the datasets, the epochs' draws, each train epoch, the validation epoch,
   checkpoint save and load, the test rollout, the artifact write, each
   closed on the card; put in around the driver from outside) and the wall
   left over;
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
   gravity --only_test false --epochs 1`` trains and rolls out on them;
17. sweep: ``python -m nonode_tpu_torch.parallel.sweep --use_fleet
   --epochs 2 --traj_len 20`` (in-process) on a JSON schedule of two grids
   into one --outf: SMOKE (charged-5, one input, EGNO and SEGNO x seeds
   1-3: two fleet groups of K=3) and SMOKE_SEQ (SEGNO, two inputs, varDT,
   seed 1: the sequential driver). Checks that the ledgers hold exactly
   the expanded configs, finite validation losses, each row's test_loss
   equal to its artifact's, #1/#2 launched as the fleets' training,
   validation and test rollouts and the sequential run's integrator steps
   ask, and that a resumed call appends nothing and launches nothing;
18. report: ``python -m nonode_tpu_torch.analysis.registry`` (in-process) on
   that --outf: three groups with their seeds, each group's mean test loss
   equal to its ledger rows' (``analysis.ledger.load_ledger_groups``, both
   ledgers) within 1e-6 relative; no launch;
19. mocap path: a CMU-style run case written under a temporary directory
   (CMU's 31-bone skeleton as an ASF, 11 AMC trials of 140 frames, parsed
   by the port's data/amc.py into motion_run.pkl: the CMU trials are not in
   the repository), then ``python -m nonode_tpu_torch.motion_main`` at
   configs/config_mocap_no.json's width (nf 128, 6 layers, T=5, batch 12)
   with ``--epochs 2 --test_interval 1``: #1/#2 at H=128 launched as the
   splits ask, the artifact's preds [240, 5, 31, 3] and its test_loss the
   MSE of its own preds within rtol 1e-5, the run's wall by PhaseTimer;
   train batch 0's loss and every gradient on the card within 1e-3 x
   max(1, max|.|) of the port's CPU; a step's wall and idle share;
20. width path: ``main --config_by_file`` with a JSON preset of nf 96
   (#1/#2 zero-padded to 128): EGNO ``--only_test false --epochs 2`` on
   512 training samples with a 2-window test rollout, on the card and on
   the CPU from the same seed, every loss within 1e-3 relative, #1/#2
   launched as the run asks; then SEGNO serving at nf 32 (padded to 64) as
   phase 7 checks it; no plain version of #1/#2 handed a CUDA tensor;
21. baselines: GNN, LinearDynamics, RFVel, EquivariantScalarNet, EGMN and
   FullMLP at hidden 64 and 4 layers on 100 graphs of the committed test
   split: a forward and one backward on the card against the port's CPU
   within 1e-3 x max(1, max|.|), every parameter given a gradient, the
   time of one forward and backward; no kernel (none in JAX either);
22. multi-rank path: a training step through the mesh's code path in a
   one-rank NCCL group, bitwise the step without a group; then gloo ranks
   sharing the card (parallel/mesh.py's backend rule): train batch 0's
   loss and gradients through ``--dp 2`` (EGNO and SEGNO, committed
   splits) and ``--dp 2 --space 2`` (EGNO on charged-10 splits that the
   port's sim.generate writes here) within 1e-4 x max(1, max|g|) of one
   process's, with rank 0's traced steps; then ``main`` at those flags
   (batch 100, 1000 training samples, 2 epochs, 2 test windows) against
   one process of the same arguments: every loss within rtol 2e-4, each
   rank's launches those of one process; the placement line, the walls
   and the launches summed over the ranks.

Every kernel's time is its device time alone (CUDA events around one call,
the stream held busy while the host enqueues it), median of repeats. Then it
prints the kernels line (each kernel's launches on its own path, and on
every path, the multi-rank paths' summed over their ranks; #1 and #2 with
their receiver-slice cases, and as their H=128 instantiations, with the
mocap path's launches) and, last, one JSON line with the device. It exits non-zero,
with no result, without CUDA, outside the repository, or when the checkout
lacks the committed splits.
"""

import collections
import contextlib
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


def pairwise_inputs(g, n, h, e, seed, dev, coord_scale=1.0, isolated=None,
                    mask=None):
    """Seeded inputs of #1/#2: G graphs of N nodes, width H, E edge features;
    the mask is complete (off the diagonal), a random sparse graph with the
    node ``isolated`` alone, or ``mask`` as given."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.tensor(scale * rng.randn(*shape), dtype=torch.float32,
                            device=dev)

    x, hi, hj, efea = f(g, n, 3), f(g, n, h, scale=0.5), \
        f(g, n, h, scale=0.5), f(g, n, n, e)
    if mask is None:
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


def pairwise_bytes(g, n, h, e, backward=False, ni=None):
    """Bytes the chain (or its backward) must move: each input read once,
    each output written once. ``ni``: the receivers of a slice (x, hj, dx
    and dhj stay N a graph; default: the whole graph)."""
    ni = n if ni is None else ni
    weights = 2 * h * h + 5 * h + e * h + 1
    inputs = (g * n * 3 + g * ni * h + g * n * h + g * ni * n * e + ni * n
              + weights)
    outputs = g * ni * 3 + g * ni * h
    if backward:
        inputs += g * ni * 3 + g * ni * h                 # the cotangents
        outputs = (g * n * 3 + g * ni * h + g * n * h + g * ni * n * e
                   + weights)
    return 4 * (inputs + outputs)


def pairwise_bound_ms(g, mask, h, e):
    """Least time for the pairwise chain on an H100 SXM: the larger of its
    operations over the fp32 peak and its bytes (each input read once, each
    output written once) over the HBM rate. The operations are those of the
    edges the [N, N] mask keeps, the only ones the outputs depend on
    (pairwise_flops_per_edge each)."""
    ni, n = mask.shape
    edges = g * int((mask != 0).sum())
    t_ops = edges * pairwise_flops_per_edge(h, e) / PEAK_FP32_FLOPS
    t_bytes = pairwise_bytes(g, n, h, e, ni=ni) / PEAK_BYTES
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
    ni, n = mask.shape
    edges = g * int((mask != 0).sum())
    products = (6 if backward else 2) * 2 * h * h
    total = (pairwise_bwd_flops_per_edge(h, e) if backward
             else pairwise_flops_per_edge(h, e))
    times = {"tensor cores": edges * 3 * products / PEAK_TF32_FLOPS,
             "CUDA cores": edges * (total - products) / PEAK_FP32_FLOPS,
             "special-function units": edges * 3 * h * 2 / PEAK_RSQRT,
             "bytes": pairwise_bytes(g, n, h, e, backward, ni) / PEAK_BYTES}
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
# None); H=64 and E=2 unless the inputs say otherwise. The EGNO slice shape
# first (held to the split-TF32 budget), then SEGNO's: G = its batch, the
# clip engaged; a G whose 25 G edge rows leave the last 128-row tile ragged;
# the mocap-like sparse graph.
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
# H=128 at the mocap path's shape: G = T x B = 5 x 12 graphs of the 31
# joints, one edge feature, the written skeleton's skeleton + 2-hop mask;
# without the clip (EGNO's layers) and with it
MOCAP_G = 60
MOCAP_CASES = [
    ("mocap G=60 N=31 H=128 E=1", dict(g=MOCAP_G, n=31, h=128, e=1,
                                       skeleton=True), False, "mocap"),
    ("mocap G=60 N=31 H=128 E=1 clip_edges=True",
     dict(g=MOCAP_G, n=31, h=128, e=1, skeleton=True, coord_scale=400.0),
     True, "mocap clip"),
]
# #1/#2 at widths they are not built for, run zero-padded to 64 (H=32) or
# 128 (H=96; H=100, not a multiple of 4) in the wrappers: EGNO's serving
# shape, held to the split-TF32 budget as the slice shape is, and with the
# clip engaged, held as H=64's clip case is; each timed, beside H=128 at
# the same shape (H=64's is the slice row)
WIDTHS = (32, 96, 100)
WIDTH_CASES = [
    case for h in WIDTHS for case in (
        (f"width H={h} G=2560 N=5 E=2", dict(g=2560, n=5, h=h), False,
         f"H={h}"),
        (f"width H={h} G=2560 clip_edges=True",
         dict(g=2560, n=5, h=h, coord_scale=400.0), True, f"H={h} clip"))
] + [("H=128 G=2560 N=5 E=2 (instantiated)", dict(g=2560, n=5, h=128),
      False, "H=128")]
# the timed rows held to the split-TF32 budget
SPLIT_TF32_ROWS = {"slice", "H=128"} | {f"H={h}" for h in WIDTHS}
# the seed-axis form of the padded widths: two weight sets over G = 2 x 1280
WIDTH_SEED_AXIS_CASES = [
    (f"H={h}", 1280, False, 1.0, dict(k=2, h=h)) for h in WIDTHS]
# the slice shape's times of the build that had H=64 alone (PERF.md §6),
# printed beside this call's
H64_ONLY_SLICE_MS = {"egnn_pairwise_fwd": "0.0481-0.0486",
                     "egnn_pairwise_bwd": "0.1806-0.1814"}


def case_inputs(kw, seed, dev):
    """(g, n, h, e, pairwise_inputs) of a PAIRWISE_CASES or MOCAP_CASES
    entry's shape and inputs."""
    kw = dict(kw)
    g, n, h, e = kw.pop("g"), kw.pop("n"), kw.pop("h", 64), kw.pop("e", 2)
    if kw.pop("skeleton", False):
        kw["mask"] = mocap_mask(dev)
    return g, n, h, e, pairwise_inputs(g, n, h, e, seed=seed, dev=dev, **kw)


def check_pairwise_kernel(egnn_fused, dev, cases=PAIRWISE_CASES):
    """Kernel vs plain version in ``cases``; returns the timed rows
    ({"slice": ..., "segno": ..., "ragged": ...} of PAIRWISE_CASES)."""
    rows = {}
    for label, kw, clip, timed in cases:
        g, n, h, e, args = case_inputs(kw, kw["n"], dev)
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
            if timed in SPLIT_TF32_ROWS and err > SPLIT_TF32_RTOL * scale:
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
        fp32 = pairwise_bound_ms(g, args[4], h, e)
        tc = pairwise_tc_bound_ms(g, args[4], h, e)
        padded, padded_text = padded_bound(egnn_fused, g, args[4], h, e, ms)
        kept = g * int((args[4] != 0).sum())
        print(f"  {label}: kernel {ms:.4f} ms, plain version {plain_ms:.4f} "
              f"ms (no yardstick), {bounds_text(fp32, tc, ms)}, over the "
              f"{kept} edges the mask keeps{padded_text}; the kernel also "
              f"computes the {g * n * n - kept} masked-out edge rows; no "
              f"single PyTorch call computes this function"
              + (f"; relative error within {SPLIT_TF32_RTOL:g}"
                 if timed in SPLIT_TF32_ROWS else "")
              + (f"; the H=64-only build: "
                 f"{H64_ONLY_SLICE_MS['egnn_pairwise_fwd']} ms"
                 if timed == "slice" else ""), flush=True)
        rows[timed] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           library_ms=None, **route_row(ms, fp32, tc),
                           **padded)
    return rows


def padded_bound(egnn_fused, g, mask, h, e, ms, backward=False):
    """For a width that runs zero-padded: ({padded_width, padded_bound_ms,
    padded_bound_share}, a clause for the printed line), the split-TF32
    bound of the work at the padded width beside the native width's that
    the row keeps; nothing for an instantiated width."""
    hp = egnn_fused.padded_width(h)
    if hp == h:
        return {}, ""
    bound_ms, pipe = pairwise_tc_bound_ms(g, mask, hp, e, backward)
    return (dict(padded_width=hp, padded_bound_ms=bound_ms,
                 padded_bound_share=bound_ms / ms),
            f"; run zero-padded to H={hp}, whose work bounds it at "
            f"{bound_ms:.4f} ms (by the {pipe}; {bound_ms / ms:.3f} of it)")


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
    ni, n = mask.shape
    edges = g * int((mask != 0).sum())
    t_ops = edges * pairwise_bwd_flops_per_edge(h, e) / PEAK_FP32_FLOPS
    t_bytes = pairwise_bytes(g, n, h, e, backward=True, ni=ni) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_outputs(out):
    dx, dhi, dhj, defea, dweights = out
    return dict(zip(("dx", "dhi", "dhj", "defea", "dwg", "dwe", "db1", "dw2",
                     "db2", "dwc1", "dbc1", "dwc2", "dbc2"),
                    (dx, dhi, dhj, defea, *dweights)))


def check_pairwise_bwd_kernel(egnn_fused, dev, cases=PAIRWISE_CASES):
    """Backward kernel vs plain version in the forward's cases, each run
    twice and held bitwise equal; returns the timed rows."""
    rows = {}
    for label, kw, clip, timed in cases:
        g, n, h, e, args = case_inputs(kw, kw["n"] + 1, dev)
        rng = np.random.RandomState(n)
        cot = tuple(torch.tensor(rng.randn(*shape), dtype=torch.float32,
                                 device=dev)
                    for shape in ((g, n, 3), (g, n, h)))
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
            if timed in SPLIT_TF32_ROWS and err > SPLIT_TF32_RTOL * scale:
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
        fp32 = pairwise_bwd_bound_ms(g, args[4], h, e)
        tc = pairwise_tc_bound_ms(g, args[4], h, e, backward=True)
        padded, padded_text = padded_bound(egnn_fused, g, args[4], h, e, ms,
                                           backward=True)
        print(f"  {label}: backward kernel {ms:.4f} ms (both launches), "
              f"plain version {plain_ms:.4f} ms (no yardstick), "
              f"{bounds_text(fp32, tc, ms)}{padded_text}; no single PyTorch "
              f"call computes this function"
              + (f"; relative error within {SPLIT_TF32_RTOL:g}"
                 if timed in SPLIT_TF32_ROWS else "")
              + (f"; the H=64-only build: "
                 f"{H64_ONLY_SLICE_MS['egnn_pairwise_bwd']} ms"
                 if timed == "slice" else ""), flush=True)
        rows[timed] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           library_ms=None, **route_row(ms, fp32, tc),
                           **padded)
    return rows


# seed-axis cases of #1/#2 (seed fleets): K weight sets over G = K x B
# graphs at EGNO's and SEGNO's shapes; (label, B, clip_edges, coord_scale)
SEEDS = 5
SEED_AXIS_CASES = [
    ("egno", 2560, False, 1.0),
    ("segno", 256, True, 400.0),
]
# and at H=128: two seeds over the mocap shape's G = 2 x 30, the clip
# engaged; (..., the shape: K, N, H, E and the skeleton mask)
MOCAP_SEED_AXIS_CASES = [
    ("mocap", MOCAP_G // 2, True, 400.0,
     dict(k=2, n=31, h=128, e=1, skeleton=True)),
]


def seed_axis_inputs(k, b, n, h, e, seed, dev, coord_scale, mask=None):
    """Inputs of G = k x b graphs and k stacked weight sets (each as
    pairwise_inputs draws one, from seeds seed .. seed + k - 1)."""
    x, hi, hj, efea, mask, _ = pairwise_inputs(k * b, n, h, e, seed, dev,
                                               mask=mask)
    sets = [pairwise_inputs(1, n, h, e, seed + 1 + s, dev,
                            coord_scale=coord_scale)[5] for s in range(k)]
    weights = tuple(torch.stack(ws) for ws in zip(*sets))
    return x, hi, hj, efea, mask, weights, sets


def check_seed_axis_kernels(egnn_fused, dev, cases=SEED_AXIS_CASES):
    """#1 and #2 with K weight sets in one launch (SEEDS at EGNO's and
    SEGNO's shapes, N=5, H=64, E=2, unless a case gives its shape): bitwise
    equal to one launch per seed, within KERNEL_RTOL x max(1, max|plain|)
    of the plain seed-axis version, bitwise repeatable; timed beside the K
    single-seed launches, with K times the single-seed split-TF32 bound.
    Returns {"egnn_pairwise_fwd": {label: row}, "egnn_pairwise_bwd": {...}}."""
    rows = {"egnn_pairwise_fwd": {}, "egnn_pairwise_bwd": {}}
    for label, b, clip, coord_scale, *shape in cases:
        shape = {"k": SEEDS, "n": 5, "h": 64, "e": 2, **(shape or [{}])[0]}
        k, n, h, e = (shape[key] for key in "knhe")
        mask = mocap_mask(dev) if shape.get("skeleton") else None
        x, hi, hj, efea, mask, weights, sets = seed_axis_inputs(
            k, b, n, h, e, 11, dev, coord_scale, mask)
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


# #1/#2 on receiver slices, the particle axis over ``--space`` ranks: the
# --dp 2 --space 2 shape of the multi-rank path, N=10 split in two slices
# of ni=5 receivers; G = 50 (a rank's batch of 50 graphs) with and without
# the clip, and G = 500 (EGNO's T x 50). (label, G, clip_edges,
# coord_scale)
SLICE_N, SLICE_SPACE = 10, 2
SLICE_CASES = [
    ("slice G=50 N=10 ni=5", 50, False, 1.0),
    ("slice G=50 N=10 ni=5 clip_edges=True", 50, True, 400.0),
    ("slice G=500 N=10 ni=5 (EGNO, T x 50)", 500, False, 1.0),
]
# a sender-side gradient (dx, dhj) and the weight gradients summed over the
# slices against the whole-graph launch: the same per-edge terms, summed
# over the receivers in two parts instead of one (about 1e-6 relative)
SLICE_RTOL = 1e-5
# sha256 of #1's and #2's H=64 outputs (scripts/time_pairwise_kernels.py:
# h64_digest) from the build that instantiated H=64 alone, on an H100 SXM
# with 132 SMs (tests/test_torch_cuda.py holds the same): the whole-graph
# launch, (0, N), keeps those bits
H64_DIGEST = "33fb1907313fbc658085584579d82703bc32911819bb4164c0b6efeb622d09c4"


def h64_digest_check(egnn_fused, dev):
    """The whole-graph launches' digest against the H=64-only build's, on
    a card of 132 SMs (the persistent grids depend on the SM count)."""
    import importlib.util

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms != 132:
        print(f"  (0, N) digest: not checked, the card has {sms} SMs",
              flush=True)
        return
    spec = importlib.util.spec_from_file_location(
        "time_pairwise_kernels", ROOT / "scripts" / "time_pairwise_kernels.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    digest = script.h64_digest(sys.modules[__name__], egnn_fused, dev)
    if digest != H64_DIGEST:
        raise AssertionError(f"#1/#2 at (0, N) lost the bits of the "
                             f"H=64-only build: digest {digest}")
    print(f"  (0, N): #1 and #2 outputs bitwise those of the H=64-only "
          f"build (sha256 {digest[:16]}...)", flush=True)


def check_slice_kernels(egnn_fused, dev, cases=SLICE_CASES):
    """#1 and #2 on SLICE_SPACE receiver slices of N=SLICE_N against the
    whole-graph launch of the same inputs: the (0, N) slice bitwise the
    launch without a slice; the slices' tot_f, tot_m, dhi and defea put
    side by side bitwise the whole launch's (each row sums over j in the
    same order; for dhi, #2's tiles hold a graph's rows whole at N = 10);
    dx, dhj and the weight gradients summed over the slices
    within SLICE_RTOL x max(1, max|whole|); each slice within KERNEL_RTOL
    of its plain version and bitwise over two runs. The second slice (i0 =
    ni) timed beside its plain version and its bound. Returns {kernel:
    {label: row}}."""
    rows = {"egnn_pairwise_fwd": {}, "egnn_pairwise_bwd": {}}
    n, ni, h, e = SLICE_N, SLICE_N // SLICE_SPACE, 64, 2
    for label, g, clip, scale in cases:
        x, hi, hj, efea, mask, w = pairwise_inputs(g, n, h, e, seed=g,
                                                   dev=dev, coord_scale=scale)
        rng = np.random.RandomState(g + 1)
        cot = tuple(torch.tensor(rng.randn(*shape), dtype=torch.float32,
                                 device=dev)
                    for shape in ((g, n, 3), (g, n, h)))

        def part(s):
            cut = lambda t, dim=1: t.narrow(  # noqa: E731
                dim, s * ni, ni).contiguous()
            return ((x, cut(hi), hj, cut(efea), cut(mask, 0), w),
                    tuple(cut(c) for c in cot), s * ni)

        parts = [part(s) for s in range(SLICE_SPACE)]
        with torch.no_grad():
            whole = egnn_fused.pairwise_message(clip, x, hi, hj, efea, mask, w)
            at0 = egnn_fused.pairwise_message(clip, x, hi, hj, efea, mask, w,
                                              i0=0)
            fwd = [egnn_fused.pairwise_message(clip, *a, i0=i0)
                   for a, _, i0 in parts]
            again = egnn_fused.pairwise_message(clip, *parts[1][0],
                                                i0=parts[1][2])
        bwhole = bwd_outputs(egnn_fused.pairwise_message_bwd(
            clip, x, hi, hj, efea, mask, w, *cot))
        bwd = [bwd_outputs(egnn_fused.pairwise_message_bwd(clip, *a, *c,
                                                           i0=i0))
               for a, c, i0 in parts]
        bagain = bwd_outputs(egnn_fused.pairwise_message_bwd(
            clip, *parts[1][0], *parts[1][1], i0=parts[1][2]))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(at0, whole)):
            raise AssertionError(f"{label}: the (0, N) slice differs from "
                                 f"the launch without a slice")
        if not all(torch.equal(a, b) for a, b in zip(again, fwd[1])) or \
                not all(torch.equal(v, bwd[1][k]) for k, v in bagain.items()):
            raise AssertionError(f"{label}: a slice differs between two "
                                 f"runs of the kernel")
        for k, name in enumerate(("tot_f", "tot_m")):
            if not torch.equal(torch.cat([f[k] for f in fwd], 1), whole[k]):
                raise AssertionError(f"{label}: the slices' {name} side by "
                                     f"side differ from the whole launch's")
        for name in ("dhi", "defea"):
            if not torch.equal(torch.cat([b[name] for b in bwd], 1),
                               bwhole[name]):
                raise AssertionError(f"{label}: the slices' {name} side by "
                                     f"side differ from the whole launch's")
        summed = {}
        for name, want in bwhole.items():
            if name in ("dhi", "defea"):
                continue
            got = sum(b[name] for b in bwd)
            rel = float((got - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            if not torch.isfinite(got).all() or rel > SLICE_RTOL:
                raise AssertionError(f"{label}: {name} summed over the "
                                     f"slices is {rel:.3e} relative from the "
                                     f"whole launch's (> {SLICE_RTOL})")
            summed[name] = rel
        errs = {"egnn_pairwise_fwd": 0.0, "egnn_pairwise_bwd": 0.0}
        for a, c, i0 in parts:
            want = egnn_fused.pairwise_message_reference(clip, *a, i0=i0)
            bwant = bwd_outputs(egnn_fused.pairwise_message_bwd_reference(
                clip, *a, *c, i0=i0))
            got = fwd[i0 // ni]
            for which, pairs in (
                    ("egnn_pairwise_fwd", zip(got, want)),
                    ("egnn_pairwise_bwd", ((bwd[i0 // ni][k], v)
                                           for k, v in bwant.items()))):
                for kern, plain in pairs:
                    err = float((kern - plain).abs().max())
                    scale_ = max(1.0, float(plain.abs().max()))
                    if err > KERNEL_RTOL * scale_:
                        raise AssertionError(
                            f"{label} slice i0={i0}: {which} disagrees with "
                            f"the plain version: {err} > {KERNEL_RTOL} x "
                            f"{scale_}")
                    errs[which] = max(errs[which], err)
        worst = max(summed, key=summed.get)
        print(f"  {label}: (0, N) bitwise the launch without a slice; "
              f"{SLICE_SPACE} slices' tot_f, tot_m, dhi, defea side by side "
              f"bitwise the whole launch's; summed dx, dhj and weight "
              f"gradients within {summed[worst]:.3e} relative ({worst}; "
              f"tolerance {SLICE_RTOL:g}); each slice within "
              f"{errs['egnn_pairwise_fwd']:.3e} (forward) and "
              f"{errs['egnn_pairwise_bwd']:.3e} (backward) of its plain "
              f"version (tolerance {KERNEL_RTOL:g} x max(1, max|plain|)); "
              f"two runs bitwise equal", flush=True)
        (a, c, i0) = parts[1]
        smask = a[4]
        timing = {
            "egnn_pairwise_fwd": (
                lambda: egnn_fused.pairwise_message(clip, *a, i0=i0),
                lambda: egnn_fused.pairwise_message_reference(clip, *a,
                                                              i0=i0),
                pairwise_bound_ms(g, smask, h, e),
                pairwise_tc_bound_ms(g, smask, h, e)),
            "egnn_pairwise_bwd": (
                lambda: egnn_fused.pairwise_message_bwd(clip, *a, *c, i0=i0),
                lambda: egnn_fused.pairwise_message_bwd_reference(
                    clip, *a, *c, i0=i0),
                pairwise_bwd_bound_ms(g, smask, h, e),
                pairwise_tc_bound_ms(g, smask, h, e, backward=True))}
        for which, (fn, fn_plain, fp32, tc) in timing.items():
            with torch.no_grad():
                ms, plain_ms = device_ms(fn), device_ms(fn_plain)
            print(f"  {label} i0={i0}: {which} kernel {ms:.4f} ms, plain "
                  f"version {plain_ms:.4f} ms (no yardstick), "
                  f"{bounds_text(fp32, tc, ms)}; no single PyTorch call "
                  f"computes this function", flush=True)
            rows[which][label] = dict(
                graphs=g, nodes=n, receivers=ni, i0=i0, clip_edges=clip,
                max_abs_err=errs[which], summed_rel_err=summed[worst]
                if which == "egnn_pairwise_bwd" else 0.0, ms=ms,
                plain_ms=plain_ms, library_ms=None, **route_row(ms, fp32, tc))
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


def fleet_launches(per_forward, k, epochs, train_b, val_b, test_b):
    """Launches of #1 and #2 on a ``fleet_main`` run of ``k`` seeds: one
    sequential run's training and validation (a fleet step launches each
    kernel once a layer or integrator step for all k seeds), then k test
    rollouts, one seed at a time."""
    want = path_launches(per_forward, 0, 0, epochs, train_b, 1, val_b)
    want["egnn_pairwise_fwd"] += k * test_b * TRAJ_LEN * per_forward
    return want


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


def cpu_first_windows(nt_main, model, data_dir, extra=()):
    """The port's own CPU rollout of the seed-42 weights over the first two
    windows of test batch 0, as [BATCH, frames, N, 3]: the windows that the
    test rollout draws from a fresh seed-42 RandomState."""
    from nonode_tpu_torch.data.nbody import NBodyDataset

    exp = seed_experiment(nt_main, model, "cpu", extra=extra)
    ds = NBodyDataset(data_dir, partition="test", traj_len=2,
                      max_samples=BATCH, device="cpu")
    perm, windows = exp.draw_epoch(ds, np.random.RandomState(SEED), BATCH,
                                   shuffle=False)
    pred, _ = exp.rollout(exp.batch(ds, windows, 0, torch.from_numpy(perm[0])),
                          2, "charged")
    return pred.transpose(0, 1).numpy()


def run_main_path(nt_main, kernels, data_dir, out_dir, model="egno",
                  extra=()):
    """``main --only_test true``: the test rollout of the seed-42 weights on
    the committed test split, #1 only; the first two windows of batch 0
    against the port's CPU rollout. ``extra``: more flags of ``main``,
    given to both runs."""
    from nonode_tpu_torch.analysis.registry import artifact_stem

    args = nt_main.get_args([
        "--model", model, "--only_test", "true", "--device", "cuda",
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN),
        "--seed", str(SEED), *extra])
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
    cpu_first = cpu_first_windows(nt_main, model, data_dir, extra)
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


@contextlib.contextmanager
def phase_breakdown(driver, dev, dataset="NBodyDataset", tests=None):
    """A PhaseTimer over the parts of a run of ``driver`` (``main`` or
    ``motion_main``), put in from outside (the driver is not changed): the
    model and its optimizer (the first Adam a process builds imports
    torch._dynamo), the datasets (the driver's ``dataset`` class, by
    partition), every epoch's draws, each train epoch (numbered), the
    validation epochs, checkpoint save and load, the test phase (``tests``:
    (class, method, label); default the EGNO and SEGNO test rollouts) and
    the artifact write, each closed on ``dev``. Yields the timer; the
    wrapped names are restored on exit."""
    from nonode_tpu_torch.train.checkpoint import EarlyStopping
    from nonode_tpu_torch.train.loop import (EGNOExperiment, SEGNOExperiment,
                                             _Experiment)
    from nonode_tpu_torch.utils.profiling import PhaseTimer

    if tests is None:
        tests = [(EGNOExperiment, "test_rollout", "test rollout"),
                 (SEGNOExperiment, "test_rollout", "test rollout")]

    timer = PhaseTimer()
    on_device = torch.zeros(1, device=dev)     # every phase waits for dev
    seen = collections.Counter()

    def numbered(name):
        def label(args, kwargs):
            seen[name] += 1
            return f"{name} {seen[name] - 1}"
        return label

    def timed(name, fn):
        def run(*args, **kwargs):
            label = name(args, kwargs) if callable(name) else name
            with timer.phase(label, block_on=on_device):
                return fn(*args, **kwargs)
        return run

    parts = [
        (driver, "build_experiment", "model build"),
        (torch.optim, "Adam", "optimizer build"),
        (driver, dataset,
         lambda args, kwargs: f"data load {kwargs['partition']}"),
        (_Experiment, "draw_epoch", "epoch draws"),
        (_Experiment, "train_epoch", numbered("train epoch")),
        (_Experiment, "eval_epoch", "validation epoch"),
        (EarlyStopping, "save_checkpoint", "checkpoint save"),
        (driver, "load_params", "checkpoint load"),
        *tests,
        (np, "savez", "artifact write"),
    ]
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in parts]
    try:
        for owner, attr, name in parts:
            setattr(owner, attr, timed(name, owner.__dict__[attr]))
        yield timer
    finally:
        for owner, attr, original in saved:
            setattr(owner, attr, original)


def breakdown_text(timer, wall):
    """The PhaseTimer's phases in order, and the wall left over."""
    summary = timer.summary()
    parts = [f"{name} {s['total_s']:.3f}" + (f" ({s['count']} calls)"
                                              if s["count"] > 1 else "")
             for name, s in summary.items()]
    left = wall - sum(timer.totals.values())
    return f"{', '.join(parts)}; left over {left:.3f} of {wall:.3f} s"


def run_train_path(nt_main, kernels, data_dir, out_dir, model="egno"):
    """``main --only_test false`` for two epochs: training, the validation
    at epoch 1, the best checkpoint saved and reloaded, the test rollout
    (``path_launches``); its wall broken down by ``phase_breakdown``."""
    from nonode_tpu_torch.analysis.registry import artifact_stem

    epochs = 2
    args = nt_main.get_args([
        "--model", model, "--only_test", "false", "--device", "cuda",
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--epochs", str(epochs), "--test_interval", "1",
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN),
        "--seed", str(SEED)])
    reset_launches(kernels)
    with phase_breakdown(nt_main, torch.device("cuda")) as timer:
        t0 = time.perf_counter()
        lines, (best_val, test_loss, best_epoch) = run_echoed(nt_main.main,
                                                              args)
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
    print(f"  {model} train path by PhaseTimer (s, each part closed on the "
          f"card): {breakdown_text(timer, wall)}", flush=True)
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
    want = fleet_launches(pf, k, epochs, train_b, val_b, test_b)
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


# the sweep phase's seeds a grid cell: a fleet group of K=3 per model
SWEEP_SEEDS = [1, 2, 3]
# a group's mean test loss in the report against its ledger rows' mean: the
# same float64 numbers summed in the same order
REPORT_RTOL = 1e-6


def sweep_schedule():
    """The sweep phase's JSON schedule: SMOKE, charged-5 with one input,
    EGNO and SEGNO x SWEEP_SEEDS (two fleet groups of K=3 under
    --use_fleet), and SMOKE_SEQ, SEGNO with two inputs and varDT, seed 1
    (no fleet: the sequential driver)."""
    def grid(**params):
        return {"method": "grid",
                "metric": {"goal": "minimize", "name": "test_loss"},
                "parameters": {k: {"values": v} if isinstance(v, list)
                               else {"value": v} for k, v in params.items()}}
    cell = dict(exp_name="_exp_new", dataset="charged", n_balls=5)
    return {"SMOKE": grid(**cell, num_inputs=1, varDT=False,
                          model=["egno", "segno"], seed=SWEEP_SEEDS),
            "SMOKE_SEQ": grid(**cell, num_inputs=2, varDT=True,
                              model="segno", seed=1)}


@contextlib.contextmanager
def counted_integrator_steps():
    """Counts SEGNO's weight-tied GCL steps (``SEGNO.integrate``), each of
    which launches #1 once and, when autograd records it (training), #2
    once in the backward. With varDT the steps a forward takes are drawn
    per batch (s + T for a drawn segment s), so they are counted, not
    reckoned. Yields {"recorded": n, "not recorded": n}."""
    from nonode_tpu_torch.models.segno import SEGNO

    original = SEGNO.__dict__["integrate"]
    steps = {"recorded": 0, "not recorded": 0}

    def integrate(self, h, x, v, edge_attr, n, rows=None):
        steps["recorded" if torch.is_grad_enabled() else "not recorded"] += n
        return original(self, h, x, v, edge_attr, n, rows)
    SEGNO.integrate = integrate
    try:
        yield steps
    finally:
        SEGNO.integrate = original


def same_loss(a, b):
    """Equal, or both NaN (a random-weight EGNO rollout may diverge)."""
    return a == b or (np.isnan(a) and np.isnan(b))


def run_sweep_phase(kernels, data_dir, tmp, dev):
    """``parallel.sweep --use_fleet`` over ``sweep_schedule()`` (SMOKE, then
    SMOKE_SEQ) into one --outf at full width on the committed splits, two
    epochs; then the same two calls again, resumed. Returns (launches, the
    outf)."""
    from nonode_tpu_torch.analysis.ledger import iter_ledger_artifacts
    from nonode_tpu_torch.parallel import sweep

    schedule, outf = tmp / "grid.json", tmp / "sweep"
    schedule.write_text(json.dumps(sweep_schedule()))
    grids = ("SMOKE", "SMOKE_SEQ")

    def run(grid):
        run_echoed(sweep.main, [
            "--schedule", str(schedule), "--grid", grid, "--data_dir",
            str(data_dir), "--outf", str(outf), "--epochs", "2",
            "--traj_len", str(TRAJ_LEN), "--use_fleet", "--device",
            dev.type])

    reset_launches(kernels)
    t0 = time.perf_counter()
    run("SMOKE")
    with counted_integrator_steps() as seq_steps:
        run("SMOKE_SEQ")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    max_samples = 3000                  # the drivers' --max_samples default
    train_b = min(max_samples, split_size(data_dir, "train")) // BATCH
    val_b = split_size(data_dir, "valid") // BATCH
    test_b = split_size(data_dir, "test") // BATCH
    if seq_steps["recorded"] < 2 * train_b * (T_MODEL + 1):
        raise AssertionError(f"the sequential run's integrator steps "
                             f"{seq_steps}: too few for 2 epochs of "
                             f"{train_b} two-input batches")
    want = {"egnn_pairwise_fwd": sum(seq_steps.values()),
            "egnn_pairwise_bwd": seq_steps["recorded"]}
    for model in ("egno", "segno"):
        for name, n in fleet_launches(EXPECT[model]["per_forward"],
                                      len(SWEEP_SEEDS), 2, train_b, val_b,
                                      test_b).items():
            want[name] += n
    launches = read_launches(
        kernels, want,
        f"sweep (fleets of K={len(SWEEP_SEEDS)}: EGNO and SEGNO training and "
        f"validation as one sequential run each, {len(SWEEP_SEEDS)} test "
        f"rollouts each; the sequential SEGNO run's {seq_steps} integrator "
        f"steps)")

    for grid in grids:
        expanded = sweep.expand_grid(sweep.load_schedule(str(schedule), grid))
        rows = [json.loads(line) for line in
                (outf / f"sweep_{grid}.jsonl").read_text().splitlines()]
        if sorted(r["config_id"] for r in rows) != sorted(
                sweep.config_id(c) for c in expanded):
            raise AssertionError(f"ledger {grid}: "
                                 f"{[r['config_id'] for r in rows]}, "
                                 f"expected {len(expanded)} configs")
    rows = []
    for rec, cfg, art in iter_ledger_artifacts(outf):
        if art is None or not np.isfinite(rec["best_val_loss"]) \
                or rec["best_epoch"] != 1 \
                or rec.get("fleet", False) != (cfg["num_inputs"] == 1):
            raise AssertionError(f"sweep row {rec} (artifact {art})")
        stored = float(np.load(art)["test_loss"])
        if not same_loss(stored, rec["test_loss"]):
            raise AssertionError(f"{rec['config_id']}: ledger test_loss "
                                 f"{rec['test_loss']}, artifact {stored}")
        check_artifact(art, test_b * BATCH, model=cfg["model"])
        rows.append(f"{cfg['model']} L={cfg['num_inputs']} seed "
                    f"{cfg['seed']}: val {rec['best_val_loss']:.5f} test "
                    f"{rec['test_loss']:.5f} run wall {rec['wall_s']} s")

    ledgers = {g: (outf / f"sweep_{g}.jsonl").read_text() for g in grids}
    reset_launches(kernels)
    t1 = time.perf_counter()
    for grid in grids:
        run(grid)
    resume_wall = time.perf_counter() - t1
    read_launches(kernels, {}, "resumed sweep (every config in the ledger)")
    if {g: (outf / f"sweep_{g}.jsonl").read_text() for g in grids} \
            != ledgers:
        raise AssertionError("a resumed sweep changed the ledger")
    print(f"  sweep: {len(rows)} configs ({'; '.join(rows)}); wall "
          f"{wall:.3f} s; resumed call {resume_wall:.3f} s, nothing run, "
          f"nothing appended; launches {json.dumps(launches)}", flush=True)
    return launches, outf


def run_report_phase(kernels, outf, report_dir):
    """``analysis.registry`` on the sweep's --outf: three groups with their
    seeds, each group's mean test loss equal to its ledger rows' within
    REPORT_RTOL (NaN-aware); no launch."""
    from nonode_tpu_torch.analysis import registry
    from nonode_tpu_torch.analysis.ledger import load_ledger_groups

    reset_launches(kernels)
    t0 = time.perf_counter()
    run_echoed(registry.main, ["--results", str(outf), "--out",
                               str(report_dir)])
    wall = time.perf_counter() - t0
    launches = read_launches(kernels, {}, "report (host numpy)")
    report = json.loads((report_dir / "report.json").read_text())
    ledger = load_ledger_groups(outf)
    want_seeds = {("egno", 1): SWEEP_SEEDS, ("segno", 1): SWEEP_SEEDS,
                  ("segno", 2): [1]}
    seen = {}
    for key, group in report["groups"].items():
        path = Path(next(iter(report["registry"][key].values())))
        cfg = registry.FNAME_RE.match(path.name).groupdict()
        model, inputs = cfg["model"].lower(), int(cfg["num_inputs"])
        rows = ledger[(model, cfg["dataset"], int(cfg["n_balls"]), inputs,
                       cfg["varDT"] == "True")]
        mean = float(np.mean([r["test"] for r in rows]))
        got = group["test_loss_mean"]
        if group["seeds"] != [str(s) for s in want_seeds.get(
                (model, inputs), [])] or len(rows) != len(group["seeds"]) \
                or not (same_loss(got, mean)
                        or abs(got - mean) <= REPORT_RTOL * abs(mean)):
            raise AssertionError(f"report group {key}: seeds "
                                 f"{group['seeds']}, test_loss_mean {got}, "
                                 f"ledger mean {mean} over {len(rows)} rows")
        seen[(model, inputs)] = f"{got:.5f} (ledger {mean:.5f})"
    if set(seen) != set(want_seeds) or len(ledger) != len(want_seeds):
        raise AssertionError(f"report groups {sorted(seen)}, ledger groups "
                             f"{sorted(ledger)}")
    table = (report_dir / "table.tex").read_text()
    print(f"  report: {len(seen)} groups, mean test loss "
          f"{json.dumps({f'{m} L={i}': v for (m, i), v in seen.items()})}; "
          f"table.tex {table.count(chr(92) * 2) - 1} rows; wall {wall:.3f} s; "
          f"launches {json.dumps(launches)}", flush=True)
    return launches


# ---- mocap: a written CMU-style run case (the CMU trials are not in the
# repository) ----

# CMU's 31-bone skeleton (the subject ASFs of mocap.cs.cmu.edu): name,
# parent, direction, length, axis (degrees), dof. The root; two legs of 5
# bones from a hip joint with no dof; a spine of 6 to the head; two arms of
# 7 from the thorax (clavicle to fingers, the thumb on the wrist). Lengths
# and directions are of CMU's order, not one subject's.
CMU_SPINE = [("lowerback", "root"), ("upperback", "lowerback"),
             ("thorax", "upperback"), ("lowerneck", "thorax"),
             ("upperneck", "lowerneck"), ("head", "upperneck")]


def cmu_bones():
    """[(name, parent, direction, length, axis, dof)] of the 30 bones, in
    the order their hierarchy lists them."""
    bones = []
    for side, sx in (("l", 1.0), ("r", -1.0)):
        bones += [
            (f"{side}hipjoint", "root", (0.6 * sx, -0.6, 0.5), 2.4,
             (0, 0, 0), ()),
            (f"{side}femur", f"{side}hipjoint", (0.34 * sx, -0.94, 0), 7.2,
             (0, 0, 20 * sx), ("rx", "ry", "rz")),
            (f"{side}tibia", f"{side}femur", (0.34 * sx, -0.94, 0), 7.5,
             (0, 0, 20 * sx), ("rx",)),
            (f"{side}foot", f"{side}tibia", (0.1 * sx, -0.2, 0.97), 2.2,
             (-90, 7 * sx, 20 * sx), ("rx", "rz")),
            (f"{side}toes", f"{side}foot", (0, 0, 1), 1.1,
             (-90, 7 * sx, 20 * sx), ("rx",))]
    bones += [(name, parent, (0, 1, 0), 2.1 if i < 3 else 1.6, (0, 0, 0),
               ("rx", "ry", "rz")) for i, (name, parent) in
              enumerate(CMU_SPINE)]
    for side, sx in (("l", 1.0), ("r", -1.0)):
        arm = (0, 0, -90 * sx)
        bones += [
            (f"{side}clavicle", "thorax", (0.95 * sx, 0.3, 0), 3.5,
             (0, 0, -20 * sx), ("ry", "rz")),
            (f"{side}humerus", f"{side}clavicle", (sx, 0, 0), 5.0, arm,
             ("rx", "ry", "rz")),
            (f"{side}radius", f"{side}humerus", (sx, 0, 0), 3.4, arm,
             ("rx",)),
            (f"{side}wrist", f"{side}radius", (sx, 0, 0), 1.7, arm, ("ry",)),
            (f"{side}hand", f"{side}wrist", (sx, 0, 0), 0.7, arm,
             ("rx", "rz")),
            (f"{side}fingers", f"{side}hand", (sx, 0, 0), 0.55, arm,
             ("rx",)),
            (f"{side}thumb", f"{side}wrist", (0.7 * sx, 0, 0.7), 0.8,
             (-90, 45 * sx, -90 * sx), ("rx", "rz"))]
    return bones


def write_cmu_asf(path):
    """The skeleton as a CMU ASF file."""
    lines = [":version 1.10", ":name smoke", ":units", "  mass 1.0",
             "  length 0.45", "  angle deg", ":documentation",
             "  CMU's 31-bone layout, written by chip_smoke.py", ":root",
             "  order TX TY TZ RX RY RZ", "  axis XYZ", "  position 0 0 0",
             "  orientation 0 0 0", ":bonedata"]
    children = collections.defaultdict(list)
    for i, (name, parent, direc, length, axis, dof) in enumerate(
            cmu_bones()):
        children[parent].append(name)
        lines += ["  begin", f"     id {i + 1}", f"     name {name}",
                  "     direction " + " ".join(f"{v:g}" for v in direc),
                  f"     length {length:g}",
                  "     axis " + " ".join(f"{v:g}" for v in axis) + " XYZ"]
        if dof:
            lines.append("    dof " + " ".join(dof))
            lines += [f"    {'limits' if k == 0 else '      '} "
                      f"(-180.0 180.0)" for k in range(len(dof))]
        lines.append("  end")
    lines += [":hierarchy", "  begin"]
    lines += [f"    {parent} {' '.join(kids)}"
              for parent, kids in children.items()]
    lines += ["  end", ""]
    Path(path).write_text("\n".join(lines))


def write_run_amc(path, frames, rng):
    """A running-like AMC trial of ``frames`` frames: every dof a sinusoid
    at one stride frequency with its own amplitude and phase, the root
    moving forward along z with a bounce."""
    period = rng.uniform(70.0, 90.0)            # frames a stride (120 fps)
    speed = rng.uniform(0.25, 0.35)
    chans = [("root", 3)] + [(name, len(dof)) for name, _, _, _, _, dof
                              in cmu_bones() if dof]
    amp = {name: rng.uniform(5.0, 35.0, k) for name, k in chans}
    phase = {name: rng.uniform(0.0, 2 * np.pi, k) for name, k in chans}
    lines = ["#!OML:ASF smoke.asf", ":FULLY-SPECIFIED", ":DEGREES"]
    for f in range(frames):
        w = 2 * np.pi * f / period
        trans = (0.5 * np.sin(w), 17.0 + 0.6 * np.sin(2 * w), speed * f)
        root = np.concatenate([trans, 0.2 * amp["root"]
                               * np.sin(w + phase["root"])])
        lines.append(str(f + 1))
        lines.append("root " + " ".join(f"{v:.6f}" for v in root))
        for name, _ in chans[1:]:
            vals = amp[name] * np.sin(w + phase[name])
            lines.append(f"{name} " + " ".join(f"{v:.6f}" for v in vals))
    Path(path).write_text("\n".join(lines) + "\n")


# The written run case: 11 trials (RUN_SPLIT's 0-10), named as CMU subject
# 9's so that trial 9 (09_10) loses its first 6 frames; 140 frames, so every
# start frame < 90 keeps its +delta_frame target after that.
MOCAP_TRIALS, MOCAP_FRAMES = 11, 140


def write_mocap_case(data_dir, seed=SEED, trials=MOCAP_TRIALS,
                     frames=MOCAP_FRAMES):
    """The ASF and AMC files under ``data_dir/amc``, parsed with the port's
    data/amc.py into ``data_dir/motion_run.pkl`` ((edges, [X_trial]), the
    motion pickles' layout). Returns (edges, trials)."""
    import pickle

    from nonode_tpu_torch.data.amc import trajectories_from_amc

    amc_dir = Path(data_dir) / "amc"
    amc_dir.mkdir(parents=True, exist_ok=True)
    write_cmu_asf(amc_dir / "09.asf")
    rng = np.random.RandomState(seed)
    amcs = []
    for i in range(trials):
        amcs.append(amc_dir / f"09_{i + 1:02d}.amc")
        write_run_amc(amcs[-1], frames, rng)
    edges, xs = trajectories_from_amc(amc_dir / "09.asf", amcs)
    with open(Path(data_dir) / "motion_run.pkl", "wb") as f:
        pickle.dump((edges, xs), f)
    return edges, xs


def mocap_mask(device):
    """The [31, 31] skeleton + 2-hop edge mask of the written skeleton, as
    the port's mocap datasets build it."""
    from nonode_tpu_torch.data.amc import Skeleton, parse_asf
    from nonode_tpu_torch.data.motion import build_edge_matrices

    with tempfile.TemporaryDirectory() as tmp:
        write_cmu_asf(Path(tmp) / "09.asf")
        skel = Skeleton(parse_asf(Path(tmp) / "09.asf"))
    _, mask = build_edge_matrices(skel.edges(), len(skel.names))
    return torch.tensor(mask, device=device)


# the mocap path at configs/config_mocap_no.json's width, cut to 2 epochs
MOCAP_ARGS = ("--nf", "128", "--n_layers", "6", "--num_timesteps", "5",
              "--batch_size", "12")


def mocap_split_sizes(data_dir, max_training_samples=200, max_eval=600):
    """Samples of each partition as the mocap datasets take them from
    ``split_run.pkl``: the first max_samples // trials starts of each
    trial (train: --max_training_samples; val and test: 600)."""
    import pickle

    with open(Path(data_dir) / "split_run.pkl", "rb") as f:
        split = pickle.load(f)
    caps = (max_training_samples, max_eval, max_eval)
    return {part: sum(min(len(v), cap // len(mapping))
                      for v in mapping.values())
            for part, mapping, cap in zip(("train", "val", "test"), split,
                                          caps)}


def run_mocap_path(kernels, tmp, dev):
    """``motion_main`` at configs/config_mocap_no.json's width (nf 128, 6
    layers, T=5, batch 12) for 2 epochs on the written run case: #1/#2
    launched as its splits ask (``path_launches``: a forward a layer, one
    decode a test batch), the results, the artifact's shapes and its
    test_loss against the MSE of its own preds; its wall by part
    (``phase_breakdown``); train batch 0's loss and every gradient on the
    card against the port's CPU; a step's wall and idle share."""
    from nonode_tpu_torch import motion_main
    from nonode_tpu_torch.analysis.registry import artifact_stem
    from nonode_tpu_torch.data.motion import MotionDynamicsDataset
    from nonode_tpu_torch.runtime import seed_everything

    data = tmp / "mocap"
    t0 = time.perf_counter()
    write_mocap_case(data)
    write_s = time.perf_counter() - t0
    args = motion_main.get_args([
        *MOCAP_ARGS, "--epochs", "2", "--test_interval", "1", "--data_dir",
        str(data), "--outf", str(tmp / "out"), "--device", dev.type])
    reset_launches(kernels)
    with phase_breakdown(motion_main, dev, "MotionDynamicsDataset",
                         [(motion_main.MotionExperiment, "test_pass",
                           "test pass")]) as timer:
        t0 = time.perf_counter()
        _, (best_val, test_loss) = run_echoed(motion_main.main, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    sizes = mocap_split_sizes(data, args.max_training_samples)
    b, layers = args.batch_size, args.n_layers
    batches = {part: n // b for part, n in sizes.items()}
    launches = read_launches(
        kernels, path_launches(layers, batches["test"], 1, args.epochs,
                               batches["train"], 1, batches["val"]),
        f"mocap path ({args.epochs} epochs x {batches['train']} batches x "
        f"{layers} layers backward; as many forward plus {batches['val']} "
        f"validation and {batches['test']} test batches x {layers})")
    run = tmp / "out" / args.exp_name
    results = json.loads((run / f"EGNO_motion_run_seed={args.seed}.json")
                         .read_text())
    losses = results["train loss"] + results["val loss"]
    if (len(results["train loss"]) != args.epochs
            or results["eval epoch"] != [1] or results["val loss"] != [best_val]
            or results["test loss"] != [test_loss]
            or not np.isfinite(losses + [test_loss]).all()):
        raise AssertionError(f"mocap results {results}")
    stem = artifact_stem("egno", "motion_run", args.seed, 31,
                         num_timesteps=args.num_timesteps)
    art = np.load(run / f"{stem}_results.npz")
    shape = (batches["test"] * b, args.num_timesteps, 31, 3)
    if art["preds"].shape != shape or art["targets"].shape != shape \
            or not np.isfinite(art["preds"]).all():
        raise AssertionError(f"mocap artifact preds {art['preds'].shape}, "
                             f"targets {art['targets'].shape}, expected "
                             f"{shape}, finite")
    mse = float(((art["preds"] - art["targets"]) ** 2).mean())
    if abs(mse - float(art["test_loss"])) > 1e-5 * abs(mse):
        raise AssertionError(f"mocap artifact test_loss {art['test_loss']}, "
                             f"its decode MSE {mse}")
    print(f"  mocap: run case written and parsed in {write_s:.3f} s "
          f"({MOCAP_TRIALS} trials, {sizes} samples); motion_main wall "
          f"{wall:.3f} s; train losses {results['train loss']} val loss "
          f"{best_val} test_loss {test_loss} (artifact decode MSE {mse}, "
          f"rtol 1e-5); launches {json.dumps(launches)}", flush=True)
    print(f"  mocap path by PhaseTimer (s, each part closed on the card): "
          f"{breakdown_text(timer, wall)}", flush=True)

    runs = []
    for where in (dev, torch.device("cpu")):
        exp = motion_main.build_experiment(args, where,
                                           seed_everything(args.seed))
        ds = MotionDynamicsDataset(
            data_dir=data, partition="train",
            max_samples=args.max_training_samples,
            delta_frame=args.delta_frame, case=args.case,
            num_timesteps=args.num_timesteps, device=where)
        perm, windows = exp.draw_epoch(ds, np.random.RandomState(args.seed),
                                       b)
        t0 = time.perf_counter()
        loss = exp._loss(exp.batch(ds, windows, 0,
                                   torch.from_numpy(perm[0]).to(where)))[0]
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in
                 exp.model.named_parameters() if p.grad is not None}
        runs.append((loss.item(), grads, time.perf_counter() - t0,
                     (exp, ds, windows, perm)))
    (loss_c, g_c, _, card), (loss_h, g_h, cpu_s, _) = runs
    if set(g_c) != set(g_h) or not g_c:
        raise AssertionError(f"mocap: parameters with a gradient differ: "
                             f"{sorted(set(g_c) ^ set(g_h))}")
    if abs(loss_c - loss_h) > GRAD_RTOL * max(1.0, abs(loss_h)):
        raise AssertionError(f"mocap loss on the card {loss_c}, on the CPU "
                             f"{loss_h}")
    worst = (0.0, "")
    for name, gh in g_h.items():
        err = float((g_c[name] - gh).abs().max())
        scale = max(1.0, float(gh.abs().max()))
        if not torch.isfinite(g_c[name]).all() or err > GRAD_RTOL * scale:
            raise AssertionError(f"mocap gradient of {name}: card vs CPU "
                                 f"{err} > {GRAD_RTOL} x {scale}")
        worst = max(worst, (err / scale, name))
    exp, ds, windows, perm = card
    step = lambda i: exp.train_epoch(  # noqa: E731
        ds, windows, perm[i % len(perm)][None])
    step_ms = median_step_ms(step)
    trace = traced(lambda: step(0))
    print(f"  mocap train batch 0: loss card {loss_c!r} CPU {loss_h!r}; "
          f"{len(g_h)} parameter gradients, worst relative error "
          f"{worst[0]:.3e} ({worst[1]}; tolerance {GRAD_RTOL:g} x max(1, "
          f"max|g|) per tensor); CPU step {cpu_s:.1f} s; training step "
          f"wall (batch {b}, sync-closed) median {step_ms:.3f} ms over steps "
          f"2-6; traced step: wall {1e3 * trace[0]:.3f} ms, device "
          f"{trace[1]:.3f} ms over {trace[2]} launches, idle share "
          f"{trace[3]:.4f}", flush=True)
    return launches


# the multi-rank path: ``main --dp/--space`` against the single process of
# the same arguments. Losses within JAX's own bound for its mesh runs
# (tests/test_driver.py:119-132: rtol 2e-4); a step's gradients within
# MESH_GRAD_RTOL x max(1, max|g|): the same fp32 terms, summed over ranks
# in another order
MESH_LOSS_RTOL = 2e-4
MESH_GRAD_RTOL = 1e-4
# the multi-rank runs: batch 100 (the reference's presets), two epochs,
# 1000 of the committed training samples and two test windows (cut to fit
# the ranks that share the card in the call)
MESH_BATCH, MESH_SAMPLES, MESH_TRAJ = 100, 1000, 2
# the charged-10 splits that the phase writes (sim.generate on the card)
MESH_N10 = {"train": 200, "valid": 100, "test": 100}


def one_rank_nccl_step(nt_main, kernels, data_dir, dev, tmp):
    """A training step of the seed-42 EGNO on train batch 0 through the
    mesh's code path in a one-rank NCCL group (the batch cut, the loss's
    share, the gradients' all-reduce in one buffer, the reported losses'
    all-reduce): the loss and every parameter after the step bitwise those
    of the step without a group."""
    import torch.distributed as dist
    from nonode_tpu_torch.parallel import mesh as meshes

    plain, _, plain_step = train_batch0(nt_main, "egno", dev, data_dir)
    exp, _, step = train_batch0(nt_main, "egno", dev, data_dir)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'nccl'}",
                            rank=0, world_size=1)
    try:
        meshes.apply_mesh(exp, meshes.make_mesh(1, 1, 0, dev, "nccl"))
        want = plain_step(0)
        reset_launches(kernels)
        got = step(0)
        torch.cuda.synchronize()
        launches = read_launches(
            kernels, {"egnn_pairwise_fwd": LAYERS,
                      "egnn_pairwise_bwd": LAYERS},
            f"one-rank NCCL step ({LAYERS} layers, forward and backward)")
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
        torch.equal(a, b) for a, b in zip(exp.model.parameters(),
                                          plain.model.parameters()))
    if not same:
        raise AssertionError("the one-rank NCCL step differs from the step "
                             "without a group")
    print(f"  one-rank NCCL group (backend {dist.Backend.NCCL}): a training "
          f"step's loss {float(got[0][0])!r} and all "
          f"{len(list(exp.model.parameters()))} parameters after it bitwise "
          f"those of the step without a group; launches "
          f"{json.dumps(launches)}", flush=True)
    return launches


def write_charged10(tmp):
    """Small charged-10 splits (60 frames) from the port's dataset writer
    on the card, for the particle axis over two ranks."""
    from nonode_tpu_torch.sim import generate

    data = tmp / "charged10"
    args = generate.get_args([
        "--simulation", "charged", "--num-train", str(MESH_N10["train"]),
        "--num-valid", str(MESH_N10["valid"]), "--num-test",
        str(MESH_N10["test"]), "--length", "6000", "--length_test", "6000",
        "--n_balls", "10", "--suffix", "small", "--chunk", "200",
        "--seed", str(SEED), "--outdir", str(data)])
    t0 = time.perf_counter()
    run_echoed(generate.main, args)
    torch.cuda.synchronize()
    print(f"  charged-10 splits {MESH_N10} written on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return data


def batch0_grads(model, where, data_dir, extra, mesh=None):
    """The seed-42 weights' loss and gradients on train batch 0 of the
    driver's first epoch (the driver flags ``extra``), through ``mesh``'s
    code path when given (the loss and the gradients summed over its
    world); then two training steps on that batch under torch.profiler.
    Returns (loss, {name: gradient on the CPU}, traced)."""
    from nonode_tpu_torch import main as nt_main
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.parallel.mesh import apply_mesh

    args = nt_main.get_args(["--model", model, *extra])
    exp = seed_experiment(nt_main, model, where, extra=extra)
    if mesh is not None:
        apply_mesh(exp, mesh)
    ds = NBodyDataset(data_dir, partition="train", n_balls=args.n_balls,
                      max_samples=args.max_samples, device=where)
    perm, windows = exp.draw_epoch(ds, np.random.RandomState(SEED),
                                   args.batch_size)
    batch = exp.batch(ds, windows, 0, torch.from_numpy(perm[0]).to(where))
    loss, _ = exp._loss(exp.shard(batch))
    loss.backward()
    loss = loss.detach().clone()
    if mesh is not None:
        mesh.all_reduce_grads(exp.model.parameters())
        mesh.all_reduce(loss)
    grads = {k: p.grad.detach().cpu() for k, p in
             exp.model.named_parameters() if p.grad is not None}
    exp.optimizer
    trace = traced(lambda: [exp.step(batch), exp.step(batch)])
    return float(loss), grads, trace


def mesh_grads_on_rank(mesh, configs):
    """``batch0_grads`` of each (label, model, data_dir, flags) of
    ``configs`` on the calling rank of ``mesh``."""
    return {label: batch0_grads(model, mesh.device, data_dir, extra, mesh)
            for label, model, data_dir, extra in configs}


def check_mesh_grads(configs, dp, space, dev):
    """Train batch 0's loss and gradients of every config through dp x
    space ranks (rank 0's, summed over the world) against the single
    process's; each within MESH_GRAD_RTOL. Prints rank 0's traced steps."""
    from nonode_tpu_torch.parallel import mesh as meshes

    t0 = time.perf_counter()
    got = meshes.launch(mesh_grads_on_rank, (configs,), dp, space, dev)
    wall = time.perf_counter() - t0
    for label, model, data_dir, extra in configs:
        loss, grads, (twall, tdev, tlaunches, idle) = got[label]
        want_loss, want, _ = batch0_grads(model, dev, data_dir, extra)
        if set(grads) != set(want) or abs(loss - want_loss) > \
                MESH_GRAD_RTOL * max(1.0, abs(want_loss)):
            raise AssertionError(f"{label}: loss {loss} against {want_loss}, "
                                 f"or other parameters with a gradient")
        worst = (0.0, "")
        for name, g in want.items():
            err = float((grads[name] - g).abs().max())
            scale = max(1.0, float(g.abs().max()))
            if not torch.isfinite(grads[name]).all() \
                    or err > MESH_GRAD_RTOL * scale:
                raise AssertionError(f"{label}: gradient of {name} through "
                                     f"the ranks vs one process {err} > "
                                     f"{MESH_GRAD_RTOL} x {scale}")
            worst = max(worst, (err / scale, name))
        print(f"  {label} train batch 0 ({dp} x {space} ranks): loss "
              f"{loss!r} against one process's {want_loss!r}; {len(want)} "
              f"gradients, worst relative error {worst[0]:.3e} ({worst[1]}; "
              f"tolerance {MESH_GRAD_RTOL:g} x max(1, max|g|)); rank 0 "
              f"traced over 2 steps: wall {1e3 * twall:.3f} ms, device "
              f"{tdev:.3f} ms over {tlaunches} launches, idle share "
              f"{idle:.4f}; the launch's wall {wall:.3f} s", flush=True)


def run_mesh_main(nt_main, kernels, label, argv, dp, space, want, n_balls,
                  tmp):
    """``main`` with ``argv`` alone and at ``--dp dp --space space``: the
    single run launches #1/#2 as ``want`` says, and so does every rank;
    the mesh run's train, validation and test losses within MESH_LOSS_RTOL
    of the single run's, its artifact of the same shapes. Returns the
    launches summed over the ranks."""
    from nonode_tpu_torch.analysis.registry import artifact_stem
    from nonode_tpu_torch.parallel import mesh as meshes

    model = argv[argv.index("--model") + 1]
    stem = artifact_stem(model, "charged", SEED, n_balls)
    runs = {}
    for name, extra in (("single", []),
                        ("mesh", ["--dp", str(dp), "--space", str(space)])):
        out = tmp / label.replace(" ", "_") / name
        args = nt_main.get_args([*argv, "--outf", str(out), *extra])
        reset_launches(kernels)
        t0 = time.perf_counter()
        lines, _ = run_echoed(nt_main.main, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(kernels, want if name == "single" else {},
                                 f"{label} {name} run in this process")
        run = out / args.exp_name
        runs[name] = (json.loads((run / f"{stem}.json").read_text()),
                      np.load(run / f"{stem}_results.npz"), wall, lines)
    ranks = meshes.launch.rank_launches
    expect = {k["name"]: want.get(k["name"], 0) for k in kernels}
    if len(ranks) != dp * space or any(r != expect for r in ranks):
        raise AssertionError(f"{label}: the ranks launched {ranks}, each "
                             f"expected {expect}")
    (res, art, wall, _), (mres, mart, mwall, mlines) = runs["single"], \
        runs["mesh"]
    for key in ("train loss", "val loss", "test loss"):
        if len(res[key]) != len(mres[key]) or not np.allclose(
                mres[key], res[key], rtol=MESH_LOSS_RTOL, atol=0,
                equal_nan=True) or not np.isfinite(res[key]).all():
            raise AssertionError(f"{label}: {key} {mres[key]} through the "
                                 f"ranks, {res[key]} alone (rtol "
                                 f"{MESH_LOSS_RTOL})")
    for key in ("targets", "preds", "energy_conservation"):
        if mart[key].shape != art[key].shape:
            raise AssertionError(f"{label}: artifact {key} has shape "
                                 f"{mart[key].shape}, alone "
                                 f"{art[key].shape}")
    summed = {k: sum(r[k] for r in ranks) for k in expect}
    worst = max(abs(a - b) / abs(b) for key in ("train loss", "val loss",
                                                "test loss")
                for a, b in zip(mres[key], res[key]))
    placement = [line for line in mlines if line.startswith("mesh: ")]
    print(f"  {label}: {placement[0] if placement else 'no placement line'}"
          f"; losses {mres['train loss']} {mres['val loss']} "
          f"{mres['test loss']} against one process's {res['train loss']} "
          f"{res['val loss']} {res['test loss']}, worst relative difference "
          f"{worst:.3e} (tolerance {MESH_LOSS_RTOL:g}); wall {mwall:.3f} s "
          f"against one process's {wall:.3f} s; each rank's launches those "
          f"of one process, summed over {dp * space} ranks "
          f"{json.dumps(summed)}", flush=True)
    return summed


def run_multi_rank_path(nt_main, kernels, data_dir, tmp, dev):
    """The mesh's code path in a one-rank NCCL group, then ``main --dp 2``
    (EGNO and SEGNO on the committed splits) and ``main --n_balls 10 --dp 2
    --space 2`` (EGNO on charged-10 splits written here) as gloo ranks
    sharing the card, each against one process: a step's gradients, then
    the two-epoch driver runs. Returns the multi-rank paths' launches
    summed over their ranks."""
    paths = {"one-rank nccl": one_rank_nccl_step(nt_main, kernels, data_dir,
                                                 dev, tmp)}
    d10 = write_charged10(tmp)
    flags = ["--batch_size", str(MESH_BATCH), "--max_samples",
             str(MESH_SAMPLES)]
    runs = [("dp2 egno", "egno", data_dir, 5, 2, 1),
            ("dp2 segno", "segno", data_dir, 5, 2, 1),
            ("dp2 space2 egno", "egno", d10, 10, 2, 2)]
    for dp, space in ((2, 1), (2, 2)):
        check_mesh_grads(
            [(label, model, d, flags + ["--n_balls", str(n)])
             for label, model, d, n, dp_, space_ in runs
             if (dp_, space_) == (dp, space)], dp, space, dev)
    for label, model, d, n, dp, space in runs:
        sizes = ({s: split_size(d, s) for s in SPLITS} if n == 5
                 else MESH_N10)
        want = path_launches(
            EXPECT[model]["per_forward"], sizes["test"] // MESH_BATCH,
            MESH_TRAJ, 2, min(MESH_SAMPLES, sizes["train"]) // MESH_BATCH,
            1, sizes["valid"] // MESH_BATCH)
        argv = ["--model", model, "--only_test", "false", "--device", "cuda",
                "--data_dir", str(d), "--n_balls", str(n), "--epochs", "2",
                "--test_interval", "1", "--traj_len", str(MESH_TRAJ),
                "--seed", str(SEED), *flags]
        paths[label] = run_mesh_main(nt_main, kernels, label, argv, dp,
                                     space, want, n, tmp)
    return paths


# the width path: EGNO at a width #1/#2 run zero-padded to 128, trained for
# two epochs on 512 training samples (2 batches of BATCH) with a 2-window
# test rollout, card and CPU; then SEGNO serving at a width padded to 64
WIDTH_EGNO_NF, WIDTH_SEGNO_NF = 96, 32
WIDTH_SAMPLES, WIDTH_TRAJ = 512, 2


@contextlib.contextmanager
def no_plain_on_card(egnn_fused):
    """Every plain version of #1/#2 raises while the block runs if it is
    handed a CUDA tensor: a path on the card must reach the kernels."""
    names = ("pairwise_message_reference", "pairwise_message_bwd_reference",
             "pairwise_message_seeds_reference",
             "pairwise_message_bwd_seeds_reference")
    saved = {name: getattr(egnn_fused, name) for name in names}

    def guard(name, fn):
        def plain(clip_edges, x, *args, **kwargs):
            if x.is_cuda:
                raise AssertionError(f"{name} was handed a CUDA tensor")
            return fn(clip_edges, x, *args, **kwargs)
        return plain

    for name, fn in saved.items():
        setattr(egnn_fused, name, guard(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(egnn_fused, name, fn)


def write_width_preset(path, nf):
    """A --config_by_file preset that sets the hidden width alone (JSON:
    the card's machine has no yaml)."""
    path.write_text(json.dumps({"nf": nf}))
    return path


def run_width_path(nt_main, kernels, egnn_fused, data_dir, tmp):
    """``main --config_by_file`` at widths #1/#2 run zero-padded: EGNO at nf
    WIDTH_EGNO_NF, ``--only_test false --epochs 2`` on WIDTH_SAMPLES
    training samples with a WIDTH_TRAJ-window test rollout, on the card
    and on the CPU from the same seed (every loss within GRAD_RTOL, the
    train step's card-vs-CPU tolerance; the checkpoint at that width);
    then SEGNO serving at nf WIDTH_SEGNO_NF (``run_main_path``: its first
    two windows against the CPU's). No plain version of #1/#2 is handed a
    CUDA tensor. Returns each run's launches on the card."""
    from nonode_tpu_torch.analysis.registry import artifact_stem

    preset = write_width_preset(tmp / "width_egno.json", WIDTH_EGNO_NF)
    argv = ["--model", "egno", "--only_test", "false", "--data_dir",
            str(data_dir), "--epochs", "2", "--test_interval", "1",
            "--batch_size", str(BATCH), "--max_samples", str(WIDTH_SAMPLES),
            "--traj_len", str(WIDTH_TRAJ), "--seed", str(SEED),
            "--config_by_file", str(preset)]
    stem = artifact_stem("egno", "charged", SEED, 5)
    train_b = min(WIDTH_SAMPLES, split_size(data_dir, "train")) // BATCH
    want = path_launches(EXPECT["egno"]["per_forward"],
                         split_size(data_dir, "test") // BATCH, WIDTH_TRAJ,
                         2, train_b, 1, split_size(data_dir, "valid") // BATCH)
    runs = {}
    for where in ("cuda", "cpu"):
        args = nt_main.get_args([*argv, "--device", where, "--outf",
                                 str(tmp / f"width_{where}")])
        reset_launches(kernels)
        t0 = time.perf_counter()
        with no_plain_on_card(egnn_fused):
            run_echoed(nt_main.main, args)
        if where == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(
            kernels, want if where == "cuda" else {},
            f"width path egno nf {WIDTH_EGNO_NF} on {where}")
        run = Path(args.outf) / args.exp_name
        hidden = torch.load(run / f"{stem}.ckpt", map_location="cpu",
                            weights_only=True)["embedding.weight"].shape[0]
        if hidden != WIDTH_EGNO_NF:
            raise AssertionError(f"the preset's width did not reach the "
                                 f"model: embedding width {hidden}")
        check_artifact(run / f"{stem}_results.npz",
                       split_size(data_dir, "test") // BATCH * BATCH,
                       traj_len=WIDTH_TRAJ)
        runs[where] = (json.loads((run / f"{stem}.json").read_text()), wall,
                       launches)
    (card, card_wall, launches), (cpu, cpu_wall, _) = runs["cuda"], \
        runs["cpu"]
    worst = 0.0
    for key in ("train loss", "val loss", "test loss"):
        a, b = np.asarray(card[key], float), np.asarray(cpu[key], float)
        if a.shape != b.shape or not np.isfinite(a).all() or not np.allclose(
                a, b, rtol=GRAD_RTOL, atol=0):
            raise AssertionError(f"width path: {key} {card[key]} on the "
                                 f"card, {cpu[key]} on the CPU (rtol "
                                 f"{GRAD_RTOL})")
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    print(f"  egno nf {WIDTH_EGNO_NF} (#1/#2 zero-padded to H="
          f"{egnn_fused.padded_width(WIDTH_EGNO_NF)}): losses "
          f"{card['train loss']} {card['val loss']} {card['test loss']} on "
          f"the card against {cpu['train loss']} {cpu['val loss']} "
          f"{cpu['test loss']} on the CPU, worst relative difference "
          f"{worst:.3e} (tolerance {GRAD_RTOL:g}); wall {card_wall:.3f} s "
          f"(CPU {cpu_wall:.3f} s); launches {json.dumps(launches)}; no "
          f"plain version handed a CUDA tensor", flush=True)
    paths = {f"width egno nf{WIDTH_EGNO_NF}": launches}
    preset = write_width_preset(tmp / "width_segno.json", WIDTH_SEGNO_NF)
    with no_plain_on_card(egnn_fused):
        paths[f"width segno nf{WIDTH_SEGNO_NF} serving"] = run_main_path(
            nt_main, kernels, data_dir, tmp / "width_segno", model="segno",
            extra=["--config_by_file", str(preset)])
    return paths


def baseline_inputs(data_dir, where, b=100):
    """The first ``b`` graphs of the committed charged-5 test split at its
    first frame, as ``main`` featurizes them (train.loop.prepare_inputs:
    h = [|v|, q], edge attributes [q_i q_j, |x_i - x_j|^2]), on ``where``:
    (loc, vel, |v|, h, edge attributes)."""
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.train.loop import prepare_inputs

    ds = NBodyDataset(data_dir, partition="test", max_samples=b,
                      device=where)
    loc, vel = ds.loc[:b, ds.start], ds.vel[:b, ds.start]
    charges, w = ds.charges[:b], ds.edge_weights[:b]
    nodes, edge_attr, _ = prepare_inputs(loc, vel, w, charges)
    vel_norm = torch.sqrt((vel * vel).sum(-1, keepdim=True))
    return loc, vel, vel_norm, nodes, edge_attr


def baseline_models(nf, e):
    """Each baseline of models/baselines.py at the reference's widths (hidden
    64, 4 layers: RFVel's defaults) for inputs of ``nf`` node features and
    ``e`` edge attributes: name -> (class, keyword arguments, a function of
    (loc, vel, |v|, h, edge attributes) that calls the model)."""
    from nonode_tpu_torch.models import baselines as bl

    return {
        "GNN": (bl.GNN, dict(n_layers=4, in_node_nf=nf, in_edge_nf=e,
                             hidden_nf=64),
                lambda m, x, v, vn, h, ea: m(h, ea)),
        "LinearDynamics": (bl.LinearDynamics, {},
                           lambda m, x, v, vn, h, ea: m(x, v)),
        "RFVel": (bl.RFVel, dict(hidden_nf=64, edge_attr_nf=e, n_layers=4),
                  lambda m, x, v, vn, h, ea: m(vn, x, v, ea)),
        "EquivariantScalarNet": (
            bl.EquivariantScalarNet,
            dict(n_vector_input=2, hidden_dim=64, n_scalar_input=nf),
            lambda m, x, v, vn, h, ea: m([x, v], h)),
        "EGMN": (bl.EGMN, dict(n_layers=4, n_vector_input=2, hidden_dim=64,
                               n_scalar_input=nf),
                 lambda m, x, v, vn, h, ea: m([x, v], h)),
        "FullMLP": (bl.FullMLP, dict(in_node_nf=6, hidden_nf=64, n_layers=4),
                    lambda m, x, v, vn, h, ea: m(torch.cat([x, v], -1))),
    }


def baseline_step(model, call, inputs):
    """A forward and the backward of sum(y^2) over its outputs: (outputs,
    {name: gradient}); every parameter must get a gradient."""
    model.zero_grad(set_to_none=True)
    outs = call(model, *inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((y * y).sum() for y in outs).backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    if missing:
        raise AssertionError(f"{type(model).__name__}: no gradient for "
                             f"{missing}")
    return ([y.detach() for y in outs],
            {n: p.grad.detach() for n, p in model.named_parameters()})


def nan_aware_rel_err(a, b):
    """max |a - b| / max(1, max|b|) over the entries where b is finite;
    raises unless a and b are NaN at the same entries."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(b)
    if not torch.equal(torch.isnan(a), nan):
        raise AssertionError("NaN at other entries on the card")
    a, b = a[~nan], b[~nan]
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def run_baselines_phase(kernels, data_dir, dev):
    """Each baseline (``baseline_models``) on a batch of 100 graphs of the
    committed split (``baseline_inputs``), seed-42 weights: a forward and
    one backward on the card against the port's CPU, every output and
    gradient within GRAD_RTOL x max(1, max|.|) (NaN at the same entries:
    RFVel's dense radial takes sqrt at the diagonal, so its gradients of
    every layer but the last are NaN, on both, as in JAX), and the time of
    one forward and backward on the card. The baselines reach no kernel, as
    in JAX: the phase launches none and is no kernel path."""
    from nonode_tpu_torch.runtime import seed_everything

    card, cpu = (baseline_inputs(data_dir, where) for where in (dev, "cpu"))
    models = baseline_models(card[3].shape[-1], card[4].shape[-1])
    reset_launches(kernels)
    for name, (cls, kw, call) in models.items():
        on_card = cls(**kw, device=dev, generator=seed_everything(SEED))
        on_cpu = cls(**kw, device="cpu", generator=seed_everything(SEED))
        outs, grads = baseline_step(on_card, call, card)
        outs_h, grads_h = baseline_step(on_cpu, call, cpu)
        errs = [nan_aware_rel_err(a, b) for a, b in zip(outs, outs_h)]
        gerrs = {n: nan_aware_rel_err(grads[n], g) for n, g in grads_h.items()}
        nans = sorted(n for n, g in grads_h.items() if torch.isnan(g).any())
        worst = max(gerrs, key=gerrs.get)
        if max(errs) > GRAD_RTOL or gerrs[worst] > GRAD_RTOL:
            raise AssertionError(f"{name}: card vs CPU outputs {errs}, "
                                 f"gradient of {worst} {gerrs[worst]} "
                                 f"(tolerance {GRAD_RTOL})")
        step = lambda: baseline_step(on_card, call, card)  # noqa: E731
        ms = device_ms(step)
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"  {name}: outputs {[tuple(o.shape) for o in outs]}, "
              f"{len(grads)} parameters with a gradient; card vs CPU worst "
              f"relative error {max(errs):.3e} (outputs), {gerrs[worst]:.3e} "
              f"(gradient of {worst}; tolerance {GRAD_RTOL:g})"
              + (f"; NaN gradients on both, as in JAX: {len(nans)} tensors "
                 f"of layers {sorted({n.split('.')[1] for n in nans})}"
                 if nans else "")
              + f"; forward and backward {ms:.4f} ms on the card by CUDA "
              f"events, {1e3 * float(np.median(walls[1:])):.3f} ms "
              f"sync-closed wall (median of 5)", flush=True)
    read_launches(kernels, {}, "baselines")
    print("  baselines: no kernel launched (the baselines reach none, in "
          "JAX as here); not a kernel path", flush=True)


# each kernel's launches on the path that runs it at full width: #1/#2 at
# H=64 on the N-body train path, the N-body kernels on their runs
OWN_PATH = {"egnn_pairwise_fwd": "train", "egnn_pairwise_bwd": "train",
            "nbody_charged_force": "stretch",
            "nbody_charged_leapfrog": "stretch",
            "nbody_gravity_accel": "gravity",
            "nbody_gravity_leapfrog": "gravity"}


def kernels_line(kernels, rows, paths, mocap_rows, mocap_launches):
    """The kernels line's entries: every kernel with its measured ``rows``
    and its launches on its own path and on every path of ``paths``; after
    #1 and #2, their H=128 instantiations (``<name>_h128``) with the mocap
    cases' ``mocap_rows`` and their launches on the mocap path."""
    out = []
    for k in kernels:
        name = k["name"]
        common = {"route": k["route"], "source": k["source"],
                  "replaces": k["replaces"], "status": "ported"}
        out.append({"name": name, **common,
                    "launches": paths[OWN_PATH[name]][name],
                    "path": OWN_PATH[name],
                    "launches_by_path": {p: c[name] for p, c in paths.items()},
                    **rows[name]})
        if name in mocap_rows:
            out.append({"name": f"{name}_h128", **common,
                        "launches": mocap_launches[name], "path": "mocap",
                        "launches_by_path": {"mocap": mocap_launches[name]},
                        **mocap_rows[name]})
    return out


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
    h64_digest_check(egnn_fused, dev)
    slice_rows = check_slice_kernels(egnn_fused, dev)
    rows = {name: dict(r["slice"], width=64, segno_shape=r["segno"],
                       ragged_shape=r["ragged"], seed_axis=seed_rows[name],
                       receiver_slice=slice_rows[name])
            for name, r in pair_rows.items()}
    mocap_rows = {
        "egnn_pairwise_fwd": check_pairwise_kernel(egnn_fused, dev,
                                                   MOCAP_CASES),
        "egnn_pairwise_bwd": check_pairwise_bwd_kernel(egnn_fused, dev,
                                                       MOCAP_CASES)}
    mocap_seed = check_seed_axis_kernels(egnn_fused, dev,
                                         MOCAP_SEED_AXIS_CASES)
    mocap_rows = {name: dict(r["mocap"], width=128,
                             clip_shape=r["mocap clip"],
                             seed_axis=mocap_seed[name])
                  for name, r in mocap_rows.items()}
    width_rows = {
        "egnn_pairwise_fwd": check_pairwise_kernel(egnn_fused, dev,
                                                   WIDTH_CASES),
        "egnn_pairwise_bwd": check_pairwise_bwd_kernel(egnn_fused, dev,
                                                       WIDTH_CASES)}
    width_seed = check_seed_axis_kernels(egnn_fused, dev,
                                         WIDTH_SEED_AXIS_CASES)
    for name, r in width_rows.items():
        rows[name]["padded_widths"] = {
            f"H={h}": dict(r[f"H={h}"], clip_shape=r[f"H={h} clip"],
                           seed_axis=width_seed[name][f"H={h}"])
            for h in WIDTHS}
        rows[name]["h128_at_this_shape"] = r["H=128"]
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

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths["sweep"], outf = run_sweep_phase(KERNELS, data_dir, Path(tmp),
                                               dev)
        phase("sweep", t0)
        t0 = time.perf_counter()
        paths["report"] = run_report_phase(KERNELS, outf,
                                           Path(tmp) / "report")
        phase("report", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mocap_launches = run_mocap_path(KERNELS, Path(tmp), dev)
    phase("mocap path", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(run_width_path(nt_main, KERNELS, egnn_fused, data_dir,
                                    Path(tmp)))
    phase("width path", t0)

    t0 = time.perf_counter()
    run_baselines_phase(KERNELS, data_dir, dev)
    phase("baselines", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(run_multi_rank_path(nt_main, KERNELS, data_dir,
                                         Path(tmp), dev))
    phase("multi-rank path", t0)

    out = kernels_line(KERNELS, rows, paths, mocap_rows, mocap_launches)
    print(json.dumps({"kernels": out}), flush=True)
    print(f"total: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
