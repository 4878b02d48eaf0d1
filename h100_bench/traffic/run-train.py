"""One seed's training of EGNO on motion capture, as ``motion_main`` runs
it: the program's ``MotionExperiment`` (``motion_main.build_experiment``)
on its ``MotionDynamicsDataset`` splits, one epoch of the training split
after another (``batch_size`` a step, drop_last, each epoch its own
permutation) through ``_Experiment.train_epoch``, the epochs' mean losses
kept on the device, and every ``test_interval``-th epoch a validation
epoch over the validation split in order, its losses read to the host
with them. No early stopping or checkpoint. The unit of work is one
training sample.

The data is a run case written from the seed (``chip_smoke.py``'s
``write_mocap_case``: CMU's 31-bone skeleton and ``trials`` AMC trials of
``frames`` frames, parsed by the port's ``data/amc.py``); the program
reads it through its own dataset, the reference gets the same samples and
graph built here from the written trials, the edges and the split.

Set-up builds the experiment from the benchmark's weights and drives it
through its first ``checked_steps`` steps and one validation epoch, with
the window's own calls; what they produce is what the reference checks,
in the fleet mix's layout with one seed (``fleet5-train.py``'s ``gaps``)."""

from __future__ import annotations

import pickle
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from h100_bench import inputs, run
from h100_bench.reference.common import AdamL2
from h100_bench.trace import span

END_TO_END = "train_samples_per_s"
# the fleet mix beside this one: its comparison and its half-batch fault,
# on one seed
_FLEET = run.mix_module("fleet5-train", Path(__file__).resolve().parents[1])
gaps = _FLEET.gaps


def _program_args(ctx, data_dir):
    """``motion_main``'s arguments for this configuration (its file as the
    ``--config_by_file`` preset); raises where the program would run a
    setting other than the file's."""
    from nonode_tpu_torch.motion_main import get_args

    args = get_args(["--device", ctx.device.type, "--data_dir",
                     str(data_dir), "--config_by_file", str(ctx.cfg_path)])
    for key, value in vars(args).items():
        if key in ctx.cfg and ctx.cfg[key] != value:
            raise ValueError(f"{ctx.name}: the program runs {key}={value}, "
                             f"the configuration states {ctx.cfg[key]}")
    return args


def _graph(edges, n):
    """The skeleton + 2-hop graph of ``edges`` over n joints: (attributes
    [N, N, 1], 1 on a bone and 2 on a 2-hop pair; mask [N, N])."""
    adj = np.zeros((n, n), np.int64)
    for a, b in edges:
        adj[a, b] = adj[b, a] = 1
    attr = np.where(adj > 0, 1, np.where(adj @ adj > 0, 2, 0))
    np.fill_diagonal(attr, 0)
    return attr[..., None].astype(np.float32), (attr > 0).astype(np.float32)


def _samples(cfg, trials, starts, max_samples):
    """{x0, v0, xt} of a split: the first max_samples // trials start
    frames of each of its trials (``starts``: {trial: start frames}); v0
    the difference to the next frame, xt the T frames ending delta_frame
    after the start. Float32, as the program holds them."""
    t, d = cfg["num_timesteps"], cfg["delta_frame"]
    each = max_samples // len(starts)
    out = {"x0": [], "v0": [], "xt": []}
    for trial, st in starts.items():
        x, st = trials[trial], np.asarray(st[:each])
        out["x0"].append(x[st])
        out["v0"].append(x[st + 1] - x[st])
        out["xt"].append(np.stack([x[st + d - t + k] for k in range(1, t + 1)],
                                  axis=1))
    return {k: np.concatenate(v).astype(np.float32) for k, v in out.items()}


def _tile_calls():
    """Calls of #1 and #2 so far that took their tile routes (the
    wrappers' ``tile_launches``); None for a program without them."""
    from nonode_tpu_torch.ops.kernels import egnn_fused

    n = [getattr(f, "tile_launches", None) for f in (
        egnn_fused.pairwise_message, egnn_fused.pairwise_message_bwd)]
    return None if None in n else sum(n)


def setup(ctx):
    import chip_smoke
    from nonode_tpu_torch.data.motion import MotionDynamicsDataset
    from nonode_tpu_torch.motion_main import build_experiment
    from nonode_tpu_torch.runtime import seed_everything

    cfg, dev = ctx.cfg, ctx.device
    tmp = tempfile.TemporaryDirectory(prefix="h100_bench_")
    seed = int(np.random.SeedSequence([ctx.seed, inputs.DATA])
               .generate_state(1)[0])
    edges, trials = chip_smoke.write_mocap_case(
        tmp.name, seed=seed, trials=cfg["trials"], frames=cfg["frames"])
    ctx.mark("data")
    args = _program_args(ctx, tmp.name)
    kw = dict(data_dir=args.data_dir, delta_frame=args.delta_frame,
              case=args.case, num_timesteps=args.num_timesteps, device=dev)
    ds_train = MotionDynamicsDataset(
        partition="train", max_samples=args.max_training_samples, **kw)
    ds_val = MotionDynamicsDataset(
        partition="val", max_samples=cfg["max_valid_samples"], **kw)
    # the split the datasets drew (and wrote) on their first read
    with open(Path(tmp.name) / "split_run.pkl", "rb") as f:
        split = pickle.load(f)
    tmp.cleanup()
    attr, mask = _graph(edges, cfg["n_node"])
    if int(mask.sum()) != cfg["mask_pairs"]:
        raise ValueError(f"{ctx.name}: the written skeleton keeps "
                         f"{int(mask.sum())} pairs, the configuration "
                         f"states {cfg['mask_pairs']}")
    host = {name: dict(_samples(cfg, trials, split[part], cap),
                       edge_attr=attr, edge_mask=mask)
            for name, part, cap in (
                ("train", 0, args.max_training_samples),
                ("valid", 1, cfg["max_valid_samples"]))}
    ctx.mark("program data")

    exp = build_experiment(args, dev, seed_everything(0))
    exp.optimizer
    ctx.mark("program and Adam")
    weights = inputs.make_weights(ctx, 1)
    params = dict(exp.model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name][0])
    b = args.batch_size
    rng = inputs.host_rng(ctx, inputs.FLEET_SEED, 0)
    vperm, _ = exp.draw_epoch(ds_val, rng, b, shuffle=False)
    st = dict(ctx=ctx, args=args, exp=exp, ds_train=ds_train, ds_val=ds_val,
              vperm=vperm, rng=rng, host=host, weights=weights)
    # the checked steps, on the first rows of a permutation of the
    # program's, drawn here so that the reference takes the same feed
    perm, _ = exp.draw_epoch(ds_train, rng, b)
    perm = perm[:ctx.params["checked_steps"]]
    first, _ = exp.train_epoch(ds_train, None, perm[:1])
    opt = exp.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    grad1 = {name: (opt.state[p]["exp_avg"] / (1 - beta1)).detach()[None]
             .clone() for name, p in params.items()}
    rest, _ = exp.train_epoch(ds_train, None, perm[1:])
    after = {name: p.detach()[None].clone() for name, p in params.items()}
    val, val_last = exp.eval_epoch(ds_val, None, vperm)
    st["checked"] = dict(perms=perm[None],
                         losses=torch.cat([first, rest])[None], grad1=grad1,
                         after=after, val=val[None], val_last=val_last[None])
    _sync(st)
    ctx.mark("checked steps and validation")
    return st


def _sync(st):
    dev = st["ctx"].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _epoch(st, epoch):
    """One training epoch, and a validation epoch after it every
    ``test_interval``-th, which reads the losses kept since the last one
    to the host. Returns (steps, validation batches)."""
    exp, args = st["exp"], st["args"]
    perm, _ = exp.draw_epoch(st["ds_train"], st["rng"], args.batch_size)
    with span("train_epoch"):
        losses, _ = exp.train_epoch(st["ds_train"], None, perm)
    st.setdefault("pending", []).append(losses.mean())
    val = 0
    if epoch % args.test_interval == 0:
        with span("eval_epoch"):
            vl, _ = exp.eval_epoch(st["ds_val"], None, st["vperm"])
            torch.stack(st.pop("pending") + [vl.mean()]).cpu()
        val = len(st["vperm"])
    return len(perm), val


def window(st, seconds):
    """Whole epochs until ``seconds`` have passed; the wall closes on a
    sync after the last epoch."""
    ctx, b = st["ctx"], st["args"].batch_size
    steps = vals = 0
    ends = []
    _sync(st)
    t0 = time.perf_counter()
    while True:
        st["epoch"] = st.get("epoch", 0) + 1
        s, v = _epoch(st, st["epoch"])
        steps, vals = steps + s, vals + v
        _sync(st)
        wall = time.perf_counter() - t0
        ends.append(wall)
        if wall >= seconds:
            break
    flops = (ctx.counts.train_flops(ctx.cfg, steps * b)
             + ctx.counts.forward_flops(ctx.cfg, vals * b))
    return {"end_to_end": {END_TO_END: steps * b / wall}, "wall_s": wall,
            "flops": flops, "attempted": steps, "failed": 0,
            "unit_ends": ends}


def stretch(st):
    """The profiled stretch: ``profiled_steps`` Adam steps. Returns what
    they did: steps, the chain's calls with their shapes (forward #1,
    backward #2) and, where the program counts them, the calls of #1 and
    #2 that took the tile routes."""
    ctx, args, exp = st["ctx"], st["args"], st["exp"]
    n = ctx.params["profiled_steps"]
    perm, _ = exp.draw_epoch(st["ds_train"], st["rng"], args.batch_size)
    before = _tile_calls()
    with span("train_epoch"):
        exp.train_epoch(st["ds_train"], None, perm[:n])
    calls = [(c * n, call) for c, call in
             ctx.counts.pairwise_calls(ctx.cfg, args.batch_size)]
    work = {"steps": n, "pairwise_fwd": calls, "pairwise_bwd": calls}
    if before is not None:
        work["tile_calls"] = _tile_calls() - before
    return work


def release(st):
    """What the checks need; the program's objects are dropped."""
    return dict(ctx=st["ctx"], host=st["host"], weights=st["weights"],
                vperm=st["vperm"], **st["checked"])


def _split(host, dev, dtype):
    return {k: torch.from_numpy(v).to(dev, dtype) for k, v in host.items()}


def reference_run(cap, loss_fn=None, dtype=torch.float32):
    """The checked steps and the validation epoch from the benchmark's
    weights, with ``loss_fn`` (by default the reference's ``train_loss``;
    the control and the faults put another in its place) and the
    reference's Adam-L2, in ``dtype``, in the fleet mix's layout with one
    seed: losses [1, steps], grad1 and after {name: [1, ...]}, val and
    val_last [1, NB]."""
    ctx = cap["ctx"]
    cfg, dev = ctx.cfg, ctx.device
    loss_fn = loss_fn or ctx.reference.train_loss
    tr = _split(cap["host"]["train"], dev, dtype)
    va = _split(cap["host"]["valid"], dev, dtype)
    perm = torch.from_numpy(np.asarray(cap["perms"][0])).to(dev)
    vperm = torch.from_numpy(np.asarray(cap["vperm"])).to(dev)
    wd = cfg["weight_decay"]
    p = {n: w[0].detach().to(dtype).requires_grad_()
         for n, w in cap["weights"].items()}
    opt = AdamL2(p, cfg["lr"], wd)
    losses, grad1 = [], None
    for idx in perm:
        loss, _ = loss_fn(p, cfg, tr, idx)
        grads = dict(zip(p, torch.autograd.grad(
            loss, list(p.values()), allow_unused=True)))
        if grad1 is None:
            grad1 = {n: (0.0 if grads[n] is None else grads[n]) + wd * t
                     for n, t in p.items()}
        losses.append(loss.detach())
        p = {n: t.requires_grad_() for n, t in opt.step(
            {n: t.detach() for n, t in p.items()}, grads).items()}
    with torch.no_grad():
        val = [loss_fn(p, cfg, va, idx) for idx in vperm]
    return dict(losses=torch.stack(losses)[None],
                grad1={n: g.detach()[None] for n, g in grad1.items()},
                after={n: t.detach()[None] for n, t in p.items()},
                val=torch.stack([v[0] for v in val])[None],
                val_last=torch.stack([v[1][-1] for v in val])[None])


def faults(ref):
    """The faults a reading needs, planted in the reference's loss: the
    fleet mix's half batch, the graph taken as complete (every pair an
    edge, its attribute as the data gives it), and the skeleton's and the
    2-hop edges' attributes swapped."""
    def complete_graph(p, cfg, split, idx):
        n = split["edge_mask"].shape[-1]
        full = 1.0 - torch.eye(n, dtype=split["edge_mask"].dtype,
                               device=split["edge_mask"].device)
        return ref.train_loss(p, cfg, dict(split, edge_mask=full), idx)

    def swapped_edge_attr(p, cfg, split, idx):
        a = split["edge_attr"]
        return ref.train_loss(p, cfg, dict(
            split, edge_attr=torch.where(a > 0, 3.0 - a, a)), idx)

    return dict(_FLEET.faults(ref), complete_graph=complete_graph,
                swapped_edge_attr=swapped_edge_attr)
