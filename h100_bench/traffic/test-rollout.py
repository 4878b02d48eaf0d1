"""The test evaluation every ``main`` and ``fleet_main`` run ends with,
called back to back: ``test_rollout`` over the test split in batches of
``batch_size`` (drop_last), each batch rolled out for ``traj_len``
fed-back windows, with the energies, the correlation and the host copies
of the artifact. The unit of work is one window of one test sample; a
call is (test samples // batch) x batch x traj_len windows.

Set-up warms the call up once. Every call, the warm-up and the window's,
is kept and checked against the reference from the same weights and
data: every window that the rate counts, as the program's rollout returns
it to ``test_rollout``, with the velocities it feeds back (held on the
card, neither copied nor launched until the window has closed), and the
artifact the call hands back, which holds only the frames an evaluation
keeps (EGNO: the first 8 of 20 windows)."""

from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch

from h100_bench import compare, inputs
from h100_bench.reference.common import charged_energy
from h100_bench.trace import span

SPLITS = ("test",)
END_TO_END = "rollout_windows_per_s"


def setup(ctx):
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.main import build_experiment
    from nonode_tpu_torch.runtime import seed_everything

    tmp, host = inputs.make_splits(ctx, SPLITS)
    args = inputs.program_args(ctx, tmp.name)
    dev = ctx.device
    exp = build_experiment(args, dev, seed_everything(0))
    kw = dict(data_dir=args.data_dir, dataset=args.dataset,
              n_balls=args.n_balls, num_timesteps=args.num_timesteps,
              num_inputs=args.num_inputs, device=dev)
    if args.model == "egno":
        kw.update(varDT=False, dT=args.dT)
    ds = NBodyDataset(partition="test", traj_len=args.traj_len, **kw)
    tmp.cleanup()
    ctx.mark("model and program data")
    weights = inputs.make_weights(ctx, 1)
    exp.model.load_state_dict({n: w[0] for n, w in weights.items()})
    st = dict(ctx=ctx, args=args, exp=exp, ds=ds, host=host,
              weights=weights, calls=[], rolled=[], stepped=[])
    exp.rollout = _kept(exp.rollout, st, "rolled")
    if hasattr(exp, "_forward"):        # EGNO's window, with its velocities
        exp._forward = _kept(exp._forward, st, "stepped")
    _call(st)                           # the warm-up, checked as the rest
    ctx.mark("warm-up call")
    return st


def _kept(fn, st, key):
    """``fn`` of the program, the first two tensors it returns kept in
    ``st[key]`` (a reference held on the card: no copy, no launch): the
    rollout's frames and energies of a batch, a window's x and v."""
    def kept(*args, **kwargs):
        out = fn(*args, **kwargs)
        st[key].append(out[:2])
        return out
    return kept


def _call(st):
    args = st["args"]
    rng = inputs.host_rng(st["ctx"], inputs.TEST)
    st["rolled"], st["stepped"] = [], []
    with span("test_rollout"):
        _, _, art = st["exp"].test_rollout(st["ds"], args.batch_size, rng)
    art = dict(preds=art["preds"], energy=art["energy_conservation"][..., 0])
    st["calls"].append(dict(rolled=st["rolled"], stepped=st["stepped"],
                            artifact=art))


def _windows(st):
    ds, args = st["ds"], st["args"]
    return (len(ds) // args.batch_size) * args.batch_size * args.traj_len


def window(st, seconds):
    """Whole calls until ``seconds`` have passed; the wall closes when the
    call that crosses it returns (its artifact is on the host)."""
    ctx = st["ctx"]
    calls = 0
    ends = []
    t0 = time.perf_counter()
    while True:
        _call(st)
        calls += 1
        wall = time.perf_counter() - t0
        ends.append(wall)
        if wall >= seconds:
            break
    windows = calls * _windows(st)
    return {"end_to_end": {END_TO_END: windows / wall}, "wall_s": wall,
            "flops": ctx.counts.forward_flops(ctx.cfg, windows),
            "attempted": calls, "failed": 0, "unit_ends": ends}


def stretch(st):
    """The profiled stretch: ``profiled_calls`` calls. Returns what they
    did: the batch windows (one fed-back window of a batch) and the
    chain's calls with their shapes (#1, one forward a batch window)."""
    ctx, args = st["ctx"], st["args"]
    n = ctx.params["profiled_calls"]
    for _ in range(n):
        _call(st)
    batch_windows = n * (len(st["ds"]) // args.batch_size) * args.traj_len
    calls = [(c * batch_windows, call) for c, call in
             ctx.counts.pairwise_calls(ctx.cfg, args.batch_size)]
    return {"windows": batch_windows, "pairwise_fwd": calls}


def release(st):
    """What the checks need, on the host; the program's objects are
    dropped. Each call: its rollout's positions [S, frames, N, 3] and
    energies [S, frames] over every window, the velocities its windows
    decoded [S, frames, N, 3] where they were kept, and its artifact."""
    calls = []
    for c in st["calls"]:
        x = torch.cat([x.transpose(0, 1) for x, _ in c["rolled"]])
        e = torch.cat([e[..., 0].transpose(0, 1) for _, e in c["rolled"]])
        call = dict(preds=x.cpu().numpy(), energy=e.cpu().numpy(),
                    artifact=c["artifact"])
        if c["stepped"]:
            per = len(c["stepped"]) // len(c["rolled"])
            v = [torch.cat([v for _, v in c["stepped"][i:i + per]])
                 .transpose(0, 1) for i in range(0, len(c["stepped"]), per)]
            call["vels"] = torch.cat(v).cpu().numpy()
        calls.append(call)
    return dict(ctx=st["ctx"], host=st["host"], weights=st["weights"],
                calls=calls)


def reference_run(cap, rollout_fn=None, dtype=torch.float32):
    """The test evaluation's rollouts of every evaluated sample from the
    benchmark's weights, over every window the program rolls out, with
    ``rollout_fn`` (by default the reference's ``rollout``; the control
    and the faults put another in its place), in ``dtype``: positions [S,
    frames, N, 3], energies [S, frames], velocities [S, frames, N, 3] and
    the data's frames they predict."""
    ctx = cap["ctx"]
    ref, cfg, dev = ctx.reference, ctx.cfg, ctx.device
    rollout_fn = rollout_fn or ref.rollout
    loc, vel, charges = cap["host"]["test"]
    split = {"loc": torch.from_numpy(loc).to(dev, dtype),
             "vel": torch.from_numpy(vel).to(dev, dtype),
             "charges": torch.from_numpy(charges).to(dev, dtype)}
    p = {n: w[0].to(dtype) for n, w in cap["weights"].items()}
    b = cfg["batch_size"]
    frames = ref.rolled_frames(cfg)
    out = dict(preds=[], energy=[], vels=[], truth=[])
    with torch.no_grad():
        for s0 in range(0, len(loc) - b + 1, b):
            idx = torch.arange(s0, s0 + b, device=dev)
            x, e, v = rollout_fn(p, cfg, split, idx, frames)
            truth = ref.truth(cfg, split, idx, frames)
            for key, t in (("preds", x), ("energy", e), ("vels", v),
                           ("truth", truth)):
                out[key].append(t.transpose(0, 1).cpu().numpy())
    return {key: np.concatenate(t) for key, t in out.items()}


def faults(ref):
    """The faults a rollout cell can have that a reading needs, planted in
    the reference's rollout: a state left unchanged (every window starts
    from the first window's input), a state fed back wrong past the
    windows an evaluation keeps, or past half of them (they start again
    from the input), and
    an answer altered where it is made (one sample's first frame moved by
    1). Half of a batch left out leaves the positions short, which reads
    infinite without a run."""
    def stuck(p, cfg, split, idx, frames):
        return _repeated(ref.rollout(p, cfg, split, idx,
                                     ref.frames_per_window(cfg)), frames)

    def restarted(p, cfg, split, idx, frames):
        f = min(ref.compared_frames(cfg), ref.frames_per_window(cfg)
                * (cfg["traj_len"] // 2))
        return _repeated(ref.rollout(p, cfg, split, idx, f), frames)

    def altered(p, cfg, split, idx, frames):
        x, e, v = ref.rollout(p, cfg, split, idx, frames)
        x = x.clone()
        x[0, min(7, x.shape[1] - 1)] += 1.0
        return x, e, v

    return {"state_unchanged": stuck, "restarted_past_kept": restarted,
            "answer_altered": altered}


def _repeated(rolled, frames):
    """A rollout's frames (x, e, v, each [F, ...]) repeated to
    ``frames``."""
    reps = -(-frames // rolled[0].shape[0])
    return tuple(t.repeat(reps, *([1] * (t.dim() - 1)))[:frames]
                 for t in rolled)


def gaps(got, refs, cap):
    """The numbers compared for ``got`` (the program's capture, every
    call, or one reference run put in its place), worst over the calls.

    Where the program hands back the velocities of every window it
    decodes (EGNO), every window is held to the reference's window from
    ``got``'s own state before it (``_stepped``): at random weights most
    rollouts amplify rounding without bound, leave any bounded region
    within 8-13 windows and end not finite, so that a free rollout can
    only be compared over its first windows, and there not steadily.
    Otherwise (SEGNO, one frame a window, every window kept) the rollout
    is compared free against the reference's (``_free``).

    ``artifact``: the largest difference between the artifact a call
    hands back and its rollout's frames that the evaluation keeps (0: the
    same values)."""
    ctx = cap["ctx"]
    kept = ctx.reference.compared_frames(ctx.cfg)
    calls = got.get("calls", [got])
    if "vels" in cap["calls"][0]:
        out = _stepped(cap, calls, refs["exact"])
    else:
        out = _free(cap, calls, refs)
    out["artifact"] = max([compare.exact_gap(
        call["artifact"][key], call[key][:, :kept])
        for call in calls if "artifact" in call
        for key in ("preds", "energy")], default=0.0)
    return out


def _free(cap, calls, refs):
    """``preds`` and ``energy`` over the frames an evaluation keeps: each
    sample's window is compared with the float64 reference's rollout
    (``exact``) while that rollout stays finite and within
    ``compare.BOUND_MULT`` times the data's range, and its gap is taken in
    units of the float32 reference's own gap there (``want``; at least
    ``compare.FLOOR``): a sample whose rollout amplifies rounding lets
    every float32 computation of it stray as far."""
    ctx = cap["ctx"]
    ref, cfg = ctx.reference, ctx.cfg
    want, exact = refs["want"], refs["exact"]
    frames = ref.frames_per_window(cfg)
    kept = ref.compared_frames(cfg)
    head = lambda side, key: _values(side, key)[:, :kept]  # noqa: E731
    region = compare.bounded_windows(head(exact, "preds"),
                                     head(exact, "truth"), frames)
    out = {}
    for key in ("preds", "energy"):
        scale = compare.window_gaps(head(want, key), head(exact, key),
                                    region, frames)
        scale = np.maximum(scale, compare.FLOOR)
        for call in calls:
            g = compare.window_gaps(head(call, key), head(exact, key),
                                    region, frames)
            out[key] = max(out.get(key, 0.0), compare.worst(
                None if g is None else g / scale))
    return out


def _values(side, key):
    """Positions [S, F, N, 3] or energies [S, F, 1] of a call or a run."""
    return side[key][..., None] if key == "energy" else side[key]


def _stepped(cap, calls, exact):
    """``preds`` and ``vels``: each window of every sample against the
    reference's window from the call's own state before it (the data's
    first frame for the first window, the last frame of the window before
    for the others: the reference's own feedback), in float64 and float32,
    compared where the float32 window is finite and the float64 one
    within ``compare.FORCED_MULT`` times the data's range (far inside
    float32's), as the worst gap in units of the float32 window's worst;
    a window whose state before it is not finite has no answer to
    compare. ``energy``: the energy of each compared frame against the
    energy of the reference's window, the same way. ``compared`` (not a
    check): the least share of the sample windows compared. Calls with
    the same frames are compared once."""
    ctx = cap["ctx"]
    fpw = ctx.reference.frames_per_window(ctx.cfg)
    bound = compare.data_bound(exact["truth"], compare.FORCED_MULT)
    out = dict(preds=0.0, vels=0.0, energy=0.0)
    seen, compared = set(), []
    for call in calls:
        if not call["preds"].shape == call.get("vels", np.zeros(0)).shape \
                == exact["preds"].shape:
            # windows missing, or no velocity for every frame decoded
            return dict(preds=math.inf, vels=math.inf, energy=math.inf)
        digest = hashlib.sha1(call["preds"].tobytes()
                              + call["vels"].tobytes()).hexdigest()
        if digest in seen:
            continue
        seen.add(digest)
        want = _forced(cap, call, torch.float32)
        exact_w = _forced(cap, call, torch.float64)
        with np.errstate(invalid="ignore"):
            inside = np.all([np.isfinite(w).all((2, 3, 4))
                             & (np.abs(e) <= bound).all((2, 3, 4))
                             for w, e in zip(want, exact_w)], axis=0)
        compared.append(inside.mean())
        for i, key in enumerate(("preds", "vels")):
            got = _by_window(call[key], fpw)[inside]
            g = compare.sample_gaps(got, exact_w[i][inside])
            u = compare.sample_gaps(want[i][inside], exact_w[i][inside])
            out[key] = max(out[key], compare.in_units(g, u))
        frames = np.repeat(inside, fpw, axis=1)
        e32, e64 = (_energy(cap, *w, dtype)[frames] for w, dtype in
                    ((want, torch.float32), (exact_w, torch.float64)))
        g = compare.sample_gaps(call["energy"][frames], e64)
        u = compare.sample_gaps(e32, e64)
        out["energy"] = max(out["energy"], compare.in_units(g, u))
    out["compared"] = float(min(compared))
    return out


def _by_window(a, fpw):
    """[S, F, ...] -> [S, W, fpw, ...]."""
    return a.reshape(a.shape[0], -1, fpw, *a.shape[2:])


def _test_tensors(cap, dtype):
    """The weights, and the test split's positions, velocities and
    charges of the evaluated samples, on the device in ``dtype``."""
    ctx = cap["ctx"]
    p = {n: w[0].to(ctx.device, dtype) for n, w in cap["weights"].items()}
    s = len(cap["calls"][0]["preds"])
    return p, [torch.from_numpy(a[:s]).to(ctx.device, dtype)
               for a in cap["host"]["test"]]


def _forced(cap, side, dtype):
    """The reference's every window, each from ``side``'s own state
    before it (the data's first frame for the first window; the last
    frame's positions and velocities of the window before for the
    others), in ``dtype``: x and v [S, W, fpw, N, 3] on the host."""
    ctx = cap["ctx"]
    ref, cfg = ctx.reference, ctx.cfg
    fpw = ref.frames_per_window(cfg)
    p, (loc, vel, charges) = _test_tensors(cap, dtype)
    f0 = cfg["frame_0"]
    state = [torch.cat([first[:, f0, None], torch.from_numpy(
        _by_window(side[key], fpw)[:, :-1, -1]).to(first)], 1)
        for first, key in ((loc, "preds"), (vel, "vels"))]
    n_win = state[0].shape[1]
    b = cfg["batch_size"]
    xs, vs = [], []
    with torch.no_grad():
        for s0 in range(0, len(loc), b):
            x0, v0 = (t[s0:s0 + b].flatten(0, 1) for t in state)
            q = charges[s0:s0 + b].repeat_interleave(n_win, 0)
            x, v = ref.window(p, cfg, x0, v0, q)
            for out, t in ((xs, x), (vs, v)):
                out.append(t.transpose(0, 1).unflatten(0, (-1, n_win))
                           .cpu().numpy())
    return np.concatenate(xs), np.concatenate(vs)


def _energy(cap, x, v, dtype):
    """The reference's energy of positions and velocities x, v [S, W,
    fpw, N, 3], in ``dtype``: [S, W * fpw] on the host."""
    _, (_, _, charges) = _test_tensors(cap, dtype)
    x, v = (torch.from_numpy(t).to(charges).flatten(1, 2) for t in (x, v))
    q = charges[..., 0]
    qq = (q[:, :, None] * q[:, None, :])[:, None]
    with torch.no_grad():
        return charged_energy(x, v, qq).cpu().numpy()
