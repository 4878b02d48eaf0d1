#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nonode_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each timed on its own line:
1. card: the GPU's name and power limit from nvidia-smi;
2. build: every CUDA kernel of the port, from nonode_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and on the edge cases, then both timed;
4. main path: ``nonode_tpu_torch.main --model egno --only_test true`` on the
   committed charged-5 test split at the canonical EGNO width (4 layers,
   hidden 64, T=10, batch 256, traj_len 20), weights from --seed 42. Checks
   the artifact's shapes, the kernel launch count, and the first two windows
   of batch 0 against the port's own CPU rollout of the same weights.

Then it prints the kernels line and, last, one JSON line with the device.
It exits non-zero, with no result, without CUDA, outside the repository, or
when the checkout lacks the committed test split.
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
# card vs CPU over two fed-back windows of the 4-layer model: the same fp32
# arithmetic in another order (cuBLAS, cuFFT and the kernel against the CPU)
ROLLOUT_RTOL = 1e-3


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


def committed_split(root=ROOT):
    """The directory of the committed charged-5 test split; raises when the
    checkout lacks it (the main path runs on that split, nothing else)."""
    data_dir = root / "data"
    missing = [f"{k}_test_charged5_initvel1small.npy"
               for k in ("loc", "vel", "charges")
               if not (data_dir / f"{k}_test_charged5_initvel1small.npy")
               .is_file()]
    if missing:
        raise FileNotFoundError(
            f"the committed test split is missing from {data_dir}: "
            f"{', '.join(missing)}; chip_smoke.py runs from a checkout of "
            f"the repository with its data/ directory")
    return data_dir


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
    art = np.load(out_dir / args.exp_name / f"{stem}_results.npz")
    metrics = [json.loads(line) for line in
               (out_dir / args.exp_name / f"{stem}_metrics.jsonl")
               .read_text().splitlines()]
    batches = 2000 // BATCH
    total = batches * BATCH
    shapes = {"targets": (total, TRAJ_LEN * 10, 5, 3),
              "preds": (total, int(0.4 * TRAJ_LEN * 10), 5, 3),
              "energy_conservation": (total, int(0.4 * TRAJ_LEN * 10), 1)}
    for key, shape in shapes.items():
        if art[key].shape != shape:
            raise AssertionError(f"{key} has shape {art[key].shape}, "
                                 f"expected {shape}")
    want = LAYERS * TRAJ_LEN * batches
    if launches["egnn_pairwise_fwd"] != want:
        raise AssertionError(f"egnn_pairwise_fwd launched "
                             f"{launches['egnn_pairwise_fwd']} times, "
                             f"expected {LAYERS} x {TRAJ_LEN} x {batches}")
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
    rows = {"egnn_pairwise_fwd": check_pairwise_kernel(egnn_fused, dev)}
    phase("kernels", t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_main_path(nt_main, KERNELS, data_dir, Path(tmp) / "out")
    phase("main path", t0)

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
