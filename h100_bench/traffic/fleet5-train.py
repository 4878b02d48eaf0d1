"""A seed fleet's training, as ``fleet_main`` runs it for a sweep cell:
K seeds trained as one program (``SeedFleet``, the loss vmapped over the
seeds' stacked parameters), one epoch of the training split after another
(``batch_size`` each seed, drop_last, each seed its own permutation), and
every ``test_interval``-th epoch a validation epoch on the batches every
seed shares, its losses brought to the host. No early stopping,
compaction or checkpoint. The unit of work is one training sample of one
seed: a step of K seeds at batch B is K B samples.

Set-up builds the fleet from the benchmark's weights and drives it through
its first ``checked_steps`` steps and one validation epoch, through the
window's own calls and feed; what they produce is what the reference
checks: each step's loss, the first gradient as Adam holds it after one
step, the parameters after the steps, the validation losses."""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench import compare, inputs
from h100_bench.reference.common import AdamL2
from h100_bench.trace import span

SPLITS = ("train", "valid")
END_TO_END = "train_samples_per_s"


def setup(ctx):
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.main import build_experiment
    from nonode_tpu_torch.parallel.fleet import SeedFleet
    from nonode_tpu_torch.runtime import seed_everything

    k = ctx.params["seeds"]
    tmp, host = inputs.make_splits(ctx, SPLITS)
    args = inputs.program_args(ctx, tmp.name)
    dev = ctx.device
    exp = build_experiment(args, dev, seed_everything(0))
    kw = dict(data_dir=args.data_dir, dataset=args.dataset,
              n_balls=args.n_balls, num_timesteps=args.num_timesteps,
              num_inputs=args.num_inputs, device=dev)
    if args.model == "egno":
        kw.update(varDT=False, dT=args.dT)
    ds_train = NBodyDataset(partition="train", max_samples=args.max_samples,
                            **kw)
    ds_val = NBodyDataset(partition="val", **kw)
    tmp.cleanup()
    ctx.mark("program data")

    fleet = SeedFleet(exp, list(range(k)))
    params, opt = fleet.init(lambda g: build_experiment(args, dev, g).model)
    ctx.mark("fleet and Adam")
    weights = inputs.make_weights(ctx, k)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    b = args.batch_size
    eval_rng = inputs.host_rng(ctx, inputs.EVAL)
    # the validation batches in order, drop_last, as fleet_main's
    vperm = np.arange(len(ds_val) // b * b).reshape(-1, b)
    win_train = exp.windows(ds_train, eval_rng, len(ds_train) // b)
    win_val = exp.windows(ds_val, eval_rng, len(vperm))
    rngs = [inputs.host_rng(ctx, inputs.FLEET_SEED, i) for i in range(k)]

    st = dict(ctx=ctx, args=args, fleet=fleet, params=params, opt=opt,
              ds_train=ds_train, ds_val=ds_val, win_train=win_train,
              win_val=win_val, vperm=vperm, rngs=rngs, host=host,
              weights=weights)
    # the checked steps, on the rows of one permutation of each seed (all
    # differ), drawn here so that the reference takes the benchmark's feed
    n = ctx.params["checked_steps"]
    perms = np.stack([r.permutation(len(ds_train))[:n * b].reshape(n, b)
                      for r in rngs])
    first, _ = fleet.train_epoch(params, opt, ds_train, win_train,
                                 perms[:, :1])
    beta1 = opt.param_groups[0]["betas"][0]
    grad1 = {name: (opt.state[p]["exp_avg"] / (1 - beta1)).detach().clone()
             if "exp_avg" in opt.state.get(p, {}) else None
             for name, p in params.items()}
    rest, _ = fleet.train_epoch(params, opt, ds_train, win_train,
                                perms[:, 1:])
    after = {name: p.detach().clone() for name, p in params.items()}
    val, val_last = fleet.eval_epoch(params, ds_val, win_val, vperm)
    st["checked"] = dict(perms=perms, losses=torch.cat([first, rest], 1),
                         grad1=grad1, after=after, val=val,
                         val_last=val_last)
    _sync(st)
    ctx.mark("checked steps and validation")
    return st


def _epoch(st, epoch):
    """One training epoch; a validation epoch after it every
    ``test_interval``-th. Returns (steps, validation batches)."""
    fleet, args = st["fleet"], st["args"]
    perms = fleet.make_perms(st["rngs"], len(st["ds_train"]),
                             args.batch_size)
    with span("train_epoch"):
        fleet.train_epoch(st["params"], st["opt"], st["ds_train"],
                          st["win_train"], perms)
    val = 0
    if epoch % args.test_interval == 0:
        with span("eval_epoch"):
            _, last = fleet.eval_epoch(st["params"], st["ds_val"],
                                       st["win_val"], st["vperm"])
            last.mean(dim=1).cpu()
        val = len(st["vperm"])
    return perms.shape[1], val


def _sync(st):
    dev = st["ctx"].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(st, seconds):
    """Whole epochs until ``seconds`` have passed; the wall closes on a
    sync after the last epoch."""
    ctx, args = st["ctx"], st["args"]
    k, b = ctx.params["seeds"], args.batch_size
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
    counts = ctx.counts
    flops = (counts.train_flops(ctx.cfg, steps * k * b)
             + counts.forward_flops(ctx.cfg, vals * k * b))
    return {"end_to_end": {END_TO_END: steps * k * b / wall},
            "wall_s": wall, "flops": flops, "attempted": steps,
            "failed": 0, "unit_ends": ends}


def stretch(st):
    """The profiled stretch: ``profiled_steps`` Adam steps of the fleet.
    Returns what they did: steps, and the chain's calls with their
    shapes (forward #1, backward #2)."""
    ctx, args, fleet = st["ctx"], st["args"], st["fleet"]
    n, k = ctx.params["profiled_steps"], ctx.params["seeds"]
    perms = fleet.make_perms(st["rngs"], len(st["ds_train"]),
                             args.batch_size)[:, :n]
    with span("train_epoch"):
        fleet.train_epoch(st["params"], st["opt"], st["ds_train"],
                          st["win_train"], perms)
    calls = [(c * n, call) for c, call in
             ctx.counts.pairwise_calls(ctx.cfg, k * args.batch_size, k)]
    return {"steps": n, "pairwise_fwd": calls, "pairwise_bwd": calls}


def release(st):
    """What the checks need; the program's objects are dropped."""
    return dict(ctx=st["ctx"], host=st["host"], weights=st["weights"],
                vperm=st["vperm"], **st["checked"])


def _split(host, name, dev, dtype):
    loc, vel, charges = host[name]
    return {"loc": torch.from_numpy(loc).to(dev, dtype),
            "vel": torch.from_numpy(vel).to(dev, dtype),
            "charges": torch.from_numpy(charges).to(dev, dtype)}


def reference_run(cap, loss_fn=None, dtype=torch.float32):
    """The checked steps and the validation epoch of every seed from the
    benchmark's weights, with ``loss_fn`` (by default the reference's
    ``train_loss``; the control and the faults put another in its place)
    and the
    reference's Adam-L2, in ``dtype``, in the layout of the program's:
    losses [K, steps], grad1 and after {name: [K, ...]}, val and val_last
    [K, NB]."""
    ctx = cap["ctx"]
    cfg, dev = ctx.cfg, ctx.device
    loss_fn = loss_fn or ctx.reference.train_loss
    tr = _split(cap["host"], "train", dev, dtype)
    va = _split(cap["host"], "valid", dev, dtype)
    perms = torch.from_numpy(np.asarray(cap["perms"])).to(dev)
    vperm = torch.from_numpy(np.asarray(cap["vperm"])).to(dev)
    lr, wd = cfg["lr"], cfg["weight_decay"]
    out = dict(losses=[], grad1=[], after=[], val=[], val_last=[])
    for s in range(perms.shape[0]):
        p = {n: w[s].detach().to(dtype).requires_grad_()
             for n, w in cap["weights"].items()}
        opt = AdamL2(p, lr, wd)
        losses, grad1 = [], None
        for b in range(perms.shape[1]):
            loss, _ = loss_fn(p, cfg, tr, perms[s, b])
            grads = dict(zip(p, torch.autograd.grad(
                loss, list(p.values()), allow_unused=True)))
            if grad1 is None:
                grad1 = {n: (0.0 if grads[n] is None else grads[n]) + wd * t
                         for n, t in p.items()}
            losses.append(loss.detach())
            p = {n: t.requires_grad_() for n, t in opt.step(
                {n: t.detach() for n, t in p.items()}, grads).items()}
        with torch.no_grad():
            val = [loss_fn(p, cfg, va, vperm[b]) for b in range(len(vperm))]
        out["losses"].append(torch.stack(losses))
        out["grad1"].append({n: g.detach() for n, g in grad1.items()})
        out["after"].append({n: t.detach() for n, t in p.items()})
        out["val"].append(torch.stack([v[0] for v in val]))
        out["val_last"].append(torch.stack([v[1][-1] for v in val]))
    stack = lambda ds: {n: torch.stack([d[n] for d in ds])  # noqa: E731
                        for n in ds[0]}
    return dict(losses=torch.stack(out["losses"]),
                grad1=stack(out["grad1"]), after=stack(out["after"]),
                val=torch.stack(out["val"]),
                val_last=torch.stack(out["val_last"]))


def faults(ref):
    """The faults a training cell can have that a reading needs, planted
    in the reference's loss (a state left unchanged reads 1 on
    ``update_norm`` and needs no run): half of every batch left out, the
    mean taken over the rest."""
    def half_batch(p, cfg, split, idx):
        return ref.train_loss(p, cfg, split, idx[:len(idx) // 2])
    return {"half_batch": half_batch}


def gaps(got, refs, cap):
    """The numbers compared for ``got`` (the program's capture, or a
    reference run put in its place), worst over the seeds: each seed's
    worst gap to the float64 reference (``exact``) in units of the float32
    reference's own worst gap over the same numbers (``want``; at least
    ``compare.FLOOR``), since a batch whose samples amplify rounding lets every
    float32 computation of it stray as far:
    ``train_loss`` (each checked step's loss, relative gap),
    ``grad_norm`` (the first gradient as Adam gets it, weight decay
    included) and ``update_norm`` (the parameters' change over the checked
    steps), both by the worst leaf as the gap between norms against the
    leaf's or the median leaf's norm, whichever is larger; ``val_loss``
    (the validation losses, the mean over the frames and the last
    frame's). Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone under Adam and are left out of
    ``update_norm``. ``*_at``: the worst leaf."""
    want, exact, weights = refs["want"], refs["exact"], cap["weights"]
    host = lambda t: t.detach().double().cpu().numpy()  # noqa: E731
    out = dict(train_loss=0.0, val_loss=0.0)
    worst = {"grad_norm": (0.0, ""), "update_norm": (0.0, "")}
    for s in range(exact["losses"].shape[0]):

        def losses(side, keys):
            return np.concatenate([compare.rel_gaps(
                host(side[k][s]), host(exact[k][s])) for k in keys])

        for name, keys in (("train_loss", ["losses"]),
                           ("val_loss", ["val", "val_last"])):
            out[name] = max(out[name], compare.in_units(
                losses(got, keys), losses(want, keys)))

        def leaves(side, field, names):
            """{name: seed s's leaf} of the first gradient or the change."""
            out = {}
            for n in names:
                t = side[field].get(n)
                if t is not None:
                    out[n] = host(t[s] - weights[n][s] if field == "after"
                                  else t[s])
            return out

        norms = {n: np.linalg.norm(host(g[s]))
                 for n, g in exact["grad1"].items()}
        small = 1e-3 * np.median(list(norms.values()))
        for key, field, names in (
                ("grad_norm", "grad1", list(norms)),
                ("update_norm", "after",
                 [n for n, v in norms.items() if v >= small])):
            e = leaves(exact, field, names)
            g = compare.norm_gaps(leaves(got, field, names), e, names)
            u = compare.norm_gaps(leaves(want, field, names), e, names)
            worst[key] = max(worst[key], (compare.in_units(g, u),
                                          f"{s}:{names[int(np.argmax(g))]}"))
    for name, (gap, at) in worst.items():
        out[name], out[name + "_at"] = gap, at
    return out
