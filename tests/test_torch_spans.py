"""The port's spans (nonode_tpu_torch/utils/profiling.py ``span``): off, a
span enters nothing; under torch.profiler it is a ``nonode:<name>`` range.
A tiny EGNO and SEGNO fleet, sequential experiment and test rollout under
the CPU profiler give each span as often as the work they did (the phases
once a step, the chain's kernels once a call, a rollout window once a batch
window), and the profiler changes no bit of what they compute.
scripts/profile_torch_training.py gives each kernel to the innermost span
around the op that launched it, a backward op's to its forward op's."""

import importlib.util
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.egno import EGNO
from nonode_tpu_torch.models.segno import SEGNO
from nonode_tpu_torch.parallel.fleet import SeedFleet
from nonode_tpu_torch.runtime import seed_everything
from nonode_tpu_torch.train.loop import EGNOExperiment, SEGNOExperiment
from nonode_tpu_torch.utils import profiling
from torch_port_util import write_charged_split

B = 8                 # batch
T = 5                 # EGNO's decoded frames; SEGNO's integrator steps
EGNO_LAYERS = 2
TRAJ_LEN = 2
SEEDS = [0, 1]
MODELS = ["egno", "segno"]
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    """Charged-5 splits of 24/16/16 samples x 55 frames."""
    d = tmp_path_factory.mktemp("span_data")
    for seed, (part, s) in enumerate((("train", 24), ("valid", 16),
                                      ("test", 16))):
        write_charged_split(d, part, seed=seed, s=s, f=55)
    return d


def _experiment(model, g):
    if model == "egno":
        return EGNOExperiment(EGNO(n_layers=EGNO_LAYERS, hidden_nf=16,
                                   time_emb_dim=8, num_timesteps=T,
                                   num_modes=2, device="cpu", generator=g),
                              lr=1e-3, weight_decay=1e-8)
    return SEGNOExperiment(SEGNO(hidden_nf=16, device="cpu", generator=g),
                           num_timesteps=T, lr=1e-3, weight_decay=1e-12)


def _ds(d, partition, model, **kw):
    if model == "egno":
        kw["varDT"] = False
    return NBodyDataset(d, partition=partition, num_timesteps=T,
                        device="cpu", **kw)


def _per_forward(model):
    """The model spans and chain calls of one forward."""
    if model == "egno":
        return {"egnn.layer": EGNO_LAYERS, "spectral.conv": 2 * EGNO_LAYERS,
                "kernel.pairwise_fwd": EGNO_LAYERS}
    return {"segno.gcl": T, "kernel.pairwise_fwd": T}


def _spans(prof):
    return Counter(e.name[len(profiling.PREFIX):] for e in prof.events()
                   if e.name.startswith(profiling.PREFIX))


def _profiled(fn, on):
    """fn() under the CPU profiler (``on``) or not; (its result, the span
    counts)."""
    if not on:
        return fn(), Counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_off_enters_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(profiling, "_RANGE", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("step.forward"):
        with profiling.span("egnn.layer"):
            pass
    assert profiling.span("a") is profiling.span("b")


@pytest.mark.parametrize("vmapped", [False, True], ids=["plain", "vmap"])
def test_span_records_a_prefixed_range_under_the_profiler(vmapped):
    def f(x):
        with profiling.span("outer"):
            with profiling.span("inner"):
                return (x * 2).sum()

    x = torch.ones(3, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.vmap(f)(x) if vmapped else f(x)
    assert _spans(prof) == {"outer": 1, "inner": 1}
    inner = next(e for e in prof.events() if e.name == "nonode:inner")
    assert inner.cpu_parent.name == "nonode:outer"


def _fleet_run(model, data, profiled):
    """Two fleet steps, a validation epoch and a test rollout of seed 0's
    experiment, from fixed weights; (losses, parameters, artifact), and the
    spans of each part."""
    build = lambda g: _experiment(model, g)  # noqa: E731
    ds, ds_val = _ds(data, "train", model), _ds(data, "val", model)
    fleet = SeedFleet(build(seed_everything(SEEDS[0])), SEEDS)
    params, opt = fleet.init(lambda g: build(g).model)
    rngs = [np.random.RandomState(s) for s in SEEDS]
    drawn = [fleet.exp.draw_epoch(ds, r, B) for r in rngs]
    perms = np.stack([p for p, _ in drawn])[:, :2]
    (losses, _), train = _profiled(lambda: fleet.train_epoch(
        params, opt, ds, drawn[0][1], perms), profiled)
    vperm, vwin = fleet.exp.draw_epoch(ds_val, np.random.RandomState(0), B,
                                       shuffle=False)
    (val, _), evals = _profiled(lambda: fleet.eval_epoch(
        params, ds_val, vwin, vperm), profiled)
    exp = build(seed_everything(SEEDS[0]))
    exp.model.load_state_dict(fleet.split(params)[0])
    ds_test = _ds(data, "test", model, traj_len=TRAJ_LEN)
    (_, _, art), rolled = _profiled(lambda: exp.test_rollout(
        ds_test, B, np.random.RandomState(0)), profiled)
    out = dict(losses=losses, val=val, params=params, artifact=art)
    return out, dict(train=train, eval=evals, rollout=rolled)


@pytest.mark.parametrize("model", MODELS)
def test_fleet_spans_count_the_work(tiny_data, model):
    """Two fleet steps: each phase once a step, the model spans and #1 once
    a forward's call, #2 once a chain call; a validation batch no phase."""
    _, spans = _fleet_run(model, tiny_data, True)
    fwd = _per_forward(model)
    chains = fwd["kernel.pairwise_fwd"]
    assert spans["train"] == Counter(
        {"step.forward": 2, "step.backward": 2, "step.optimizer": 2,
         "kernel.pairwise_bwd": 2 * chains,
         **{k: 2 * v for k, v in fwd.items()}})
    nb = 16 // B
    assert spans["eval"] == Counter({k: nb * v for k, v in fwd.items()})


@pytest.mark.parametrize("model", MODELS)
def test_rollout_spans_count_the_work(tiny_data, model):
    """A test rollout of 2 batches x 2 windows: one ``rollout.window`` a
    batch window, the energy, metrics and readback once a batch, the batch
    once a batch (EGNO once more, for the call's index arrays)."""
    _, spans = _fleet_run(model, tiny_data, True)
    batches = 16 // B
    windows = batches * TRAJ_LEN
    want = {"rollout.window": windows, "rollout.energy": batches,
            "rollout.metrics": batches, "rollout.readback": batches,
            "rollout.batch": batches + (model == "egno"),
            **{k: windows * v for k, v in _per_forward(model).items()}}
    assert spans["rollout"] == Counter(want)


@pytest.mark.parametrize("model", MODELS)
def test_experiment_spans_count_the_work(tiny_data, model):
    """The sequential experiment's steps carry the same phases as the
    fleet's, and each batch's gather (training and validation) its
    ``step.batch``; its validation batch no other phase."""
    exp = _experiment(model, seed_everything(0))
    ds = _ds(tiny_data, "train", model)
    perm, windows = exp.draw_epoch(ds, np.random.RandomState(0), B)
    _, spans = _profiled(lambda: (exp.train_epoch(ds, windows, perm[:2]),
                                  exp.eval_epoch(ds, windows, perm[:1])),
                         True)
    fwd = _per_forward(model)
    assert spans == Counter(
        {"step.batch": 3, "step.forward": 2, "step.backward": 2,
         "step.optimizer": 2,
         "kernel.pairwise_bwd": 2 * fwd["kernel.pairwise_fwd"],
         **{k: 3 * v for k, v in fwd.items()}})


@pytest.mark.parametrize("model", MODELS)
def test_the_profiler_changes_no_bit(tiny_data, model):
    """Losses, validation losses, parameters and the rollout's artifact
    with the profiler on equal those with it off, bit for bit."""
    off, _ = _fleet_run(model, tiny_data, False)
    on, _ = _fleet_run(model, tiny_data, True)
    for key in ("losses", "val"):
        assert torch.equal(on[key], off[key]), key
    for name, p in off["params"].items():
        assert torch.equal(on["params"][name], p), name
    for key, a in off["artifact"].items():
        np.testing.assert_array_equal(on["artifact"][key], a, err_msg=key)


def _event(name, parent=None, seq=-1, thread=1, fwd_thread=0, kernels=()):
    return SimpleNamespace(name=name, cpu_parent=parent, sequence_nr=seq,
                           thread=thread, fwd_thread=fwd_thread,
                           kernels=[SimpleNamespace(name=k, duration=us)
                                    for k, us in kernels])


def test_profile_script_gives_each_kernel_to_the_innermost_span():
    path = REPO / "scripts" / "profile_torch_training.py"
    spec = importlib.util.spec_from_file_location("profile_training", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    step = _event("nonode:step.forward")
    layer = _event("nonode:egnn.layer", step)
    node = _event(script.BACKWARD + ": MmBackward0", seq=7, thread=2,
                  fwd_thread=1)
    linear = _event("aten::linear", layer)
    events = [step, layer, linear,
              _event("aten::mm", linear, seq=7, kernels=[("gemm", 5.0)]),
              _event("nonode:kernel.pairwise_fwd", layer,
                     kernels=[("fwd", 3.0)]),
              node, _event("aten::mm", node, thread=2,
                           kernels=[("gemm", 4.0)]),
              _event("aten::copy_", kernels=[("copy", 1.0)])]
    got = {s: dict(k) for s, k in script.device_us_by_span(events).items()}
    assert got == {"egnn.layer": {"gemm": 5.0},
                   "kernel.pairwise_fwd": {"fwd": 3.0},
                   "egnn.layer (backward of aten::linear)": {"gemm": 4.0},
                   "none": {"copy": 1.0}}
    # a real CPU profile's events have every field it reads (no kernels)
    exp = _experiment("segno", seed_everything(0))
    x = torch.randn(B, 5, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.model(x.norm(dim=-1, keepdim=True), x, x,
                  torch.randn(B, 5, 5, 2), T=2)[0].sum().backward()
    assert script.device_us_by_span(prof.events()) == {}
