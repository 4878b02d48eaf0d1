"""The rollout's fed-back windows as CUDA graphs (train/loop.py
``_Experiment._roll`` on train/graphs.py's step runner, the ``rollout``
kind), with the capture stubbed on the CPU as tests/test_torch_fleet.py
stubs the steps': which windows warm up, capture and replay, what makes a
new key, what stays eager (the CPU, a mesh, SEGNO's windows before the
``in_steps`` fixed point), EGNO's ``_forward`` as the benchmark's rollout
mix wraps it, and the eager rollout's bits. EGNO and SEGNO, one input and
three (varDT), on a tiny charged-5 test split. The card's graphs:
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.egno import EGNO
from nonode_tpu_torch.models.segno import SEGNO
from nonode_tpu_torch.parallel import mesh as meshes
from nonode_tpu_torch.runtime import seed_everything
from nonode_tpu_torch.train.loop import EGNOExperiment, SEGNOExperiment
from test_torch_fleet import _stub_capture
from torch_port_util import write_charged_split

CASES = ["egno", "egno-multi", "segno", "segno-multi"]
B = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rollout_data(tmp_path_factory):
    """A charged-5 test split of 16 samples x 70 frames: 2 batches of 8,
    up to 6 fed-back windows each."""
    d = tmp_path_factory.mktemp("rollout_graphs")
    write_charged_split(d, "test", seed=3, s=16, f=70)
    return d


def _setup(case, data, graphed, capture_runs=False):
    """(experiment from seed 0's weights, the keys its stubbed capture
    took, the test split): ``case`` a model with one input, or three with
    varDT (``-multi``); the capture stubbed when ``graphed``, and running
    the captured body once on its zeroed buffers, as a CUDA capture
    records it, with ``capture_runs``."""
    model, _, multi = case.partition("-")
    L = 3 if multi else 1
    g = seed_everything(0)
    if model == "egno":
        exp = EGNOExperiment(EGNO(
            device="cpu", generator=g, n_layers=2, hidden_nf=16,
            time_emb_dim=8, num_timesteps=5, num_modes=2, num_inputs=L,
            varDT=L > 1))
    else:
        exp = SEGNOExperiment(SEGNO(
            hidden_nf=16, multiple_agg="attn" if multi else None,
            device="cpu", generator=g), num_timesteps=5, varDT=L > 1)
    kw = dict(partition="test", num_inputs=L, num_timesteps=5, traj_len=6)
    if model == "egno":
        kw["varDT"] = L > 1
    ds = NBodyDataset(data, device="cpu", **kw)
    captured = _stub_capture(exp) if graphed else []
    if capture_runs:
        stub = exp._steps.capture

        class Recorded(stub):
            def __init__(self, key, body, inputs, keep):
                super().__init__(key, body, inputs, keep)
                for buf in self.inputs:
                    buf.zero_()
                self.out = body(*self.inputs)

        exp._steps.capture = Recorded
    return exp, captured, ds


def _kinds(exp, captured):
    """The list that every rollout window of ``exp`` appends its kind to:
    "eager", "capture" (captured and replayed) or "replay"; and the live
    rollout graph after each window. A window is a call of EGNO's
    ``_forward`` (outside a rollout only the loss calls it), or of
    SEGNO's ``_roll``."""
    kinds, live = [], []
    name = "_forward" if hasattr(exp, "_forward") else "_roll"
    window = getattr(exp, name)

    def recorded(*args, **kwargs):
        c, r = len(captured), exp.rollout_replays
        out = window(*args, **kwargs)
        kinds.append("capture" if len(captured) > c else
                     "replay" if exp.rollout_replays > r else "eager")
        live.append(exp._steps.graphs.get("rollout"))
        return out

    setattr(exp, name, recorded)
    return kinds, live


def _calls(exp, ds, n=2, b=B):
    """``n`` test_rollout calls, each on the same draws."""
    return [exp.test_rollout(ds, b, np.random.RandomState(7))
            for _ in range(n)]


@pytest.mark.parametrize("case", CASES)
def test_rollout_windows_warm_up_capture_then_replay(rollout_data, case):
    """A call's first window runs eagerly, its second captures and
    replays, the rest replay, and a second call and every later batch
    capture nothing; SEGNO's windows before the ``in_steps`` fixed point
    (two with three inputs) run eagerly in every batch. The training and
    validation count stays 0. Both calls' losses, steps and artifacts are
    the eager rollout's, bit for bit."""
    runs = []
    for graphed in (False, True):
        exp, captured, ds = _setup(case, rollout_data, graphed)
        kinds, _ = _kinds(exp, captured)
        runs.append((exp, captured, kinds, _calls(exp, ds)))
    (eexp, _, ek, eout), (gexp, gcap, gk, gout) = runs
    w = len(ek) // 4                      # windows a batch; 2 calls x 2
    assert w >= 4 and ek == ["eager"] * 4 * w
    pre = 2 if case == "segno-multi" else 0
    first = ["eager"] * (pre + 1) + ["capture"] + ["replay"] * (w - pre - 2)
    later = ["eager"] * pre + ["replay"] * (w - pre)
    assert gk == first + later * 3
    assert len(gcap) == 1
    assert gexp.rollout_replays == 4 * (w - pre) - 1
    assert eexp.rollout_replays == gexp.replays == eexp.replays == 0
    np.testing.assert_equal(gout, eout)
    preds = gout[0][2]["preds"]
    assert not np.array_equal(preds[:, 0], preds[:, -1])


@pytest.mark.parametrize("case", ["egno", "egno-multi"])
def test_the_forward_as_the_rollout_mix_wraps_it(rollout_data, case):
    """EGNO's ``exp._forward`` wrapped as h100_bench's rollout mix wraps it
    (each call's first two outputs kept by reference) sees one call a
    window, none from the capture (which runs the body), and outputs that
    hold the eager windows' bits after every later window: no replay
    overwrites them. A validation epoch's ``_loss`` afterwards does not
    reach the rollout graph."""
    runs = []
    for graphed in (False, True):
        exp, captured, ds = _setup(case, rollout_data, graphed, graphed)
        kinds, _ = _kinds(exp, captured)
        kept = []
        forward = exp._forward

        def counted(*args, **kwargs):
            out = forward(*args, **kwargs)
            kept.append(out[:2])
            return out

        exp._forward = counted
        _calls(exp, ds)
        runs.append((exp, captured, kinds, kept, ds))
    (_, _, ek, ekept, _), (gexp, gcap, gk, gkept, ds) = runs
    assert len(gkept) == len(ekept) == len(gk) == len(ek)
    assert gk.count("capture") == len(gcap) == 1
    assert len({t.data_ptr() for pair in gkept for t in pair}) \
        == 2 * len(gkept)
    for got, want in zip(gkept, ekept):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    graph, replays = gexp._steps.graphs["rollout"], gexp.rollout_replays
    perm, windows = gexp.draw_epoch(ds, np.random.RandomState(0), B)
    gexp.eval_epoch(ds, windows, perm)
    assert len(perm) == 2 and gexp.replays == 1 and len(gcap) == 2
    assert gexp._steps.graphs["rollout"] is graph
    assert gexp.rollout_replays == replays


@pytest.mark.parametrize("change", ["storage", "batch"])
@pytest.mark.parametrize("model", ["egno", "segno"])
def test_a_changed_rollout_key_captures_again(rollout_data, model, change):
    """After a parameter's storage is replaced, or at another batch size,
    the next call's first window runs eagerly, its second captures anew
    (the old graph freed), and the rest replay."""
    exp, captured, ds = _setup(model, rollout_data, True)
    kinds, _ = _kinds(exp, captured)
    _calls(exp, ds, 1)
    old = exp._steps.graphs["rollout"]
    if change == "storage":
        p = next(exp.model.parameters())
        p.data = p.data.clone()
    del kinds[:]
    _calls(exp, ds, 1, B if change == "storage" else B // 2)
    assert kinds[:2] == ["eager", "capture"] and len(kinds) > 2
    assert set(kinds[2:]) == {"replay"}
    assert len(captured) == 2 and captured[0] != captured[1]
    assert exp._steps.graphs["rollout"] is not old


def test_windows_before_the_fixed_point_leave_the_live_graph(rollout_data):
    """SEGNO with three inputs: the windows before the ``in_steps`` fixed
    point run eagerly under no key, and the graph captured at the fixed
    point stays live through them, batch after batch."""
    exp, captured, ds = _setup("segno-multi", rollout_data, True)
    kinds, live = _kinds(exp, captured)
    _calls(exp, ds)
    graph = live[kinds.index("capture")]
    assert graph is not None and len(captured) == 1
    after = live[kinds.index("capture"):]
    assert all(g is graph for g in after)
    assert kinds.count("eager") == 3 + 2 * 3


@pytest.mark.parametrize("case", ["cpu", "mesh"])
@pytest.mark.parametrize("model", ["egno", "segno"])
def test_the_cpu_and_a_mesh_keep_the_rollout_eager(rollout_data,
                                                   monkeypatch, model,
                                                   case):
    """On the CPU no window is graphed; with a mesh (one rank here) every
    window stays eager, and the call gives the rollout without a mesh."""
    exp, captured, ds = _setup(model, rollout_data, case == "mesh")
    if case == "mesh":
        monkeypatch.setattr(meshes.dist, "all_reduce",
                            lambda t, group=None: None)    # a world of one
        exp.mesh = meshes.Mesh(1, 1, 0, torch.device("cpu"), "gloo", None,
                               None, None)
    got = _calls(exp, ds)
    assert exp.rollout_replays == 0 and not captured
    assert not exp._steps.graphs
    plain, _, _ = _setup(model, rollout_data, False)
    np.testing.assert_equal(got, _calls(plain, ds))
