#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nonode_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed on its own line:
1. card: the GPU's name and power limit from nvidia-smi;
2. build: every CUDA kernel of the port, from nonode_tpu_torch/csrc/, one
   nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and on the edge cases, then both timed; the
   backward kernel twice, bitwise equal;
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
   wall of a training step.

Then it prints the kernels line (launches from the train path) and, last,
one JSON line with the device. It exits non-zero, with no result, without
CUDA, outside the repository, or when the checkout lacks the committed
splits.
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
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version: fp32 on both sides, sums of <= 64 products taken
# in another order
KERNEL_RTOL = 1e-4
# card vs CPU over two fed-back windows of the 4-layer model, and for the
# gradients of one training step: the same fp32 arithmetic in another order
# (cuBLAS, cuFFT and the kernels against the CPU) through 4 layers
ROLLOUT_RTOL = 1e-3
GRAD_RTOL = 1e-3
SPLITS = ("test", "train", "valid")


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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


def pairwise_bound_ms(g, mask, h, e):
    """Least time for the pairwise chain on an H100 SXM: the larger of its
    operations over the fp32 peak and its bytes (each input read once, each
    output written once) over the HBM rate. The operations are those of the
    edges the [N, N] mask keeps, the only ones the outputs depend on: per
    edge, the three products and the first layer as multiply-adds (2 FLOP
    each), plus 12 FLOP per hidden unit for bias adds and the three SiLUs."""
    n = mask.shape[-1]
    edges = g * int((mask != 0).sum())
    flops = edges * (2 * (2 * h * h + h + e * h + h) + 12 * h)
    inputs = g * n * 3 + 2 * g * n * h + g * n * n * e + n * n \
        + (2 * h * h + 5 * h + e * h + 1)
    outputs = g * n * 3 + g * n * h
    nbytes = 4 * (inputs + outputs)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
            torch.cuda.synchronize()
            want = egnn_fused.pairwise_message_reference(clip, *args)
        errs = []
        for name, a, b in zip(("tot_f", "tot_m"), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: kernel {name} not finite")
            err = float((a - b).abs().max())
            scale = max(1.0, float(b.abs().max()))
            print(f"  {label}: {name} max_abs_err {err:.3e} "
                  f"max_rel_err {err / scale:.3e} "
                  f"(tolerance {KERNEL_RTOL:g} x max(1, max|plain|))",
                  flush=True)
            if err > KERNEL_RTOL * scale:
                raise AssertionError(f"{label}: {name} disagrees with the "
                                     f"plain version: {err} > "
                                     f"{KERNEL_RTOL} x {scale}")
            errs.append(err)
        if row is None:
            with torch.no_grad():
                ms = cuda_ms(lambda: egnn_fused.pairwise_message(clip, *args))
                plain_ms = cuda_ms(lambda: egnn_fused.pairwise_message_reference(
                    clip, *args))
            bound_ms, bound_by = pairwise_bound_ms(g, args[4], 64, 2)
            kept = g * int((args[4] != 0).sum())
            print(f"  kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms "
                  f"(no yardstick), bound {bound_ms:.4f} ms by {bound_by} "
                  f"over the {kept} edges the mask keeps; the kernel also "
                  f"computes the {g * n * n - kept} masked-out edge rows; no "
                  f"single PyTorch call computes this function", flush=True)
            row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
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
    flops = edges * pairwise_bwd_flops_per_edge(h, e)
    weights = 2 * h * h + 5 * h + e * h + 1
    inputs = g * n * 3 + 2 * g * n * h + g * n * n * e + n * n + weights \
        + g * n * 3 + g * n * h
    outputs = g * n * 3 + 2 * g * n * h + g * n * n * e + weights
    nbytes = 4 * (inputs + outputs)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
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
            errs.append(err)
            worst = max(worst, (err / scale, name))
        print(f"  {label}: backward max_abs_err {max(errs):.3e}, worst "
              f"relative {worst[0]:.3e} ({worst[1]}; tolerance "
              f"{KERNEL_RTOL:g} x max(1, max|plain|) per output); two runs "
              f"bitwise equal", flush=True)
        if row is None:
            ms = cuda_ms(lambda: egnn_fused.pairwise_message_bwd(
                clip, *args, *cot))
            plain_ms = cuda_ms(lambda: egnn_fused.pairwise_message_bwd_reference(
                clip, *args, *cot))
            bound_ms, bound_by = pairwise_bwd_bound_ms(g, args[4], 64, 2)
            print(f"  backward kernel {ms:.4f} ms (both launches), plain "
                  f"version {plain_ms:.4f} ms (no yardstick), bound "
                  f"{bound_ms:.4f} ms by {bound_by}; no single PyTorch call "
                  f"computes this function", flush=True)
            row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return row


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


def check_artifact(path, total):
    """The test rollout's artifact has the shapes of ``total`` samples,
    TRAJ_LEN windows of T=10 frames and the 40% horizon cut."""
    art = np.load(path)
    shapes = {"targets": (total, TRAJ_LEN * 10, 5, 3),
              "preds": (total, int(0.4 * TRAJ_LEN * 10), 5, 3),
              "energy_conservation": (total, int(0.4 * TRAJ_LEN * 10), 1)}
    for key, shape in shapes.items():
        if art[key].shape != shape:
            raise AssertionError(f"{key} has shape {art[key].shape}, "
                                 f"expected {shape}")
    return art


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
    for k in kernels:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    _, test_loss, _ = nt_main.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k["name"]: k["wrapper"].launches for k in kernels}

    stem = artifact_stem("egno", "charged", SEED, 5)
    metrics = [json.loads(line) for line in
               (out_dir / args.exp_name / f"{stem}_metrics.jsonl")
               .read_text().splitlines()]
    batches = split_size(data_dir, "test") // BATCH
    art = check_artifact(out_dir / args.exp_name / f"{stem}_results.npz",
                         batches * BATCH)
    want = {"egnn_pairwise_fwd": LAYERS * TRAJ_LEN * batches,
            "egnn_pairwise_bwd": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}: "
                             f"{LAYERS} x {TRAJ_LEN} x {batches} forward, no "
                             f"backward")
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


def run_train_path(nt_main, kernels, data_dir, out_dir):
    """``main --only_test false`` for two epochs: 2 x (train batches) x 4
    backward launches; the same forward launches plus (valid batches) x 4 at
    the epoch-1 validation and the test rollout's 4 x TRAJ_LEN x (test
    batches)."""
    import contextlib
    import io

    from nonode_tpu_torch.analysis.registry import artifact_stem

    epochs = 2
    args = nt_main.get_args([
        "--model", "egno", "--only_test", "false", "--device", "cuda",
        "--data_dir", str(data_dir), "--outf", str(out_dir),
        "--epochs", str(epochs), "--test_interval", "1",
        "--batch_size", str(BATCH), "--traj_len", str(TRAJ_LEN),
        "--seed", str(SEED)])
    log = io.StringIO()
    for k in kernels:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        best_val, test_loss, best_epoch = nt_main.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k["name"]: k["wrapper"].launches for k in kernels}
    lines = log.getvalue().splitlines()
    for line in lines:
        if not line.startswith("Namespace("):
            print(f"  | {line}", flush=True)

    train_b = min(args.max_samples, split_size(data_dir, "train")) // BATCH
    val_b = split_size(data_dir, "valid") // BATCH
    test_b = split_size(data_dir, "test") // BATCH
    bwd = epochs * train_b * LAYERS
    want = {"egnn_pairwise_fwd": bwd + val_b * LAYERS
            + LAYERS * TRAJ_LEN * test_b, "egnn_pairwise_bwd": bwd}
    if launches != want:
        raise AssertionError(
            f"train path launches {launches}, expected {want}: {epochs} "
            f"epochs x {train_b} batches x {LAYERS} layers backward; as many "
            f"forward plus {val_b} validation batches x {LAYERS} and "
            f"{LAYERS} x {TRAJ_LEN} x {test_b} in the test rollout")

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
    build.build_all([k["csrc"] for k in KERNELS])
    for k in KERNELS:
        for line in build.BUILD_LOGS.get(k["csrc"], "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k['name']} ptxas: {line.strip()}", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    rows = {"egnn_pairwise_fwd": check_pairwise_kernel(egnn_fused, dev),
            "egnn_pairwise_bwd": check_pairwise_bwd_kernel(egnn_fused, dev)}
    phase("kernels", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_main_path(nt_main, KERNELS, data_dir, Path(tmp) / "out")
    phase("main path", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_train_path(nt_main, KERNELS, data_dir,
                                  Path(tmp) / "out")
    phase("train path", t0)

    t0 = time.perf_counter()
    check_train_step(data_dir, dev)
    phase("train step", t0)

    out = []
    for k in KERNELS:
        out.append({"name": k["name"], "route": k["route"],
                    "source": k["source"], "replaces": k["replaces"],
                    "status": "ported", "launches": launches[k["name"]],
                    **rows[k["name"]]})
    print(json.dumps({"kernels": out}), flush=True)
    print(f"total: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
