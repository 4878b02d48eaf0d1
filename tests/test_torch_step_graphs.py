"""The per-seed loop's steps as CUDA graphs (train/loop.py ``_Experiment``
on train/graphs.py's mechanism, which the seed fleet shares), with the
capture stubbed on the CPU as tests/test_torch_fleet.py stubs the fleet's:
which steps warm up, capture and replay, what makes a new key, what stays
eager, and the eager loop's bits. EGNO and SEGNO run on tiny charged-5
splits, mocap's EGNO (``motion_main.build_experiment``, nf 16, 2 layers)
on a written run case. The card's graphs: tests/test_torch_cuda.py."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from nonode_tpu_torch import motion_main
from nonode_tpu_torch.data.motion import MotionDynamicsDataset
from nonode_tpu_torch.parallel import mesh as meshes
from nonode_tpu_torch.runtime import seed_everything
from test_torch_fleet import (_ds, _egno_build, _kind, _segno_build,
                              _stub_capture, tiny_data)  # noqa: F401

MODELS = ["egno", "segno", "mocap"]
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mocap_case(tmp_path_factory):
    """chip_smoke's written run case (CMU's skeleton, 11 trials)."""
    d = tmp_path_factory.mktemp("mocap_graphs")
    chip_smoke.write_mocap_case(d)
    return d


def _setup(model, tiny_data, mocap_case, graphed):
    """(experiment, captured keys, (train split, its windows), (validation
    split, its windows), batch size): the experiment from seed 0's
    weights, its capture stubbed when ``graphed``."""
    if model == "mocap":
        args = motion_main.get_args(["--device", "cpu", "--data_dir",
                                     str(mocap_case), "--nf", "16",
                                     "--n_layers", "2"])
        exp = motion_main.build_experiment(args, torch.device("cpu"),
                                           seed_everything(0))
        train, val = (MotionDynamicsDataset(
            data_dir=mocap_case, partition=part, max_samples=n,
            delta_frame=args.delta_frame, case=args.case,
            num_timesteps=args.num_timesteps) for part, n in (
                ("train", 200), ("val", 600)))
        b = 4
    else:
        exp = (_egno_build() if model == "egno" else _segno_build())(
            seed_everything(0))
        train, val = (_ds(tiny_data, part, model=model)
                      for part in ("train", "val"))
        b = 8
    captured = _stub_capture(exp) if graphed else []
    return (exp, captured, (train, exp.windows(train, None, 3)),
            (val, exp.windows(val, None, 2)), b)


def _perm(n, rows, b, seed=0):
    """``rows`` batches of ``b`` samples: the batches of permutations of
    the n samples, one epoch after another."""
    rng = np.random.RandomState(seed)
    per = n // b
    return np.concatenate([rng.permutation(n)[:per * b].reshape(per, b)
                           for _ in range(-(-rows // per))])[:rows]


@pytest.mark.parametrize("model", MODELS)
def test_per_seed_steps_warm_up_capture_then_replay(tiny_data, mocap_case,
                                                    model):
    """A key's first step runs eagerly, its second captures and replays,
    later ones replay; training and validation each keep their own graph,
    and ``replays`` counts the replays. The graphed loop's per-batch
    losses (one per step, all distinct), parameters, Adam moments and
    validation losses are the eager loop's, bit for bit."""
    runs = []
    for graphed in (False, True):
        exp, captured, (ds, windows), (ds_val, vwin), b = _setup(
            model, tiny_data, mocap_case, graphed)
        perm = _perm(len(ds), 6, b)
        vperm = np.arange(2 * b).reshape(2, b)
        kinds, losses, vals = [], [], []

        def train(i):
            losses.append(exp.train_epoch(ds, windows, perm[i:i + 1]))

        def val(i):
            vals.append(exp.eval_epoch(ds_val, vwin, vperm[i:i + 1]))

        for i in range(3):
            kinds.append(_kind(exp, captured, lambda: train(i)))
        for i in (0, 1, 0):
            kinds.append(_kind(exp, captured, lambda: val(i)))
        for i in range(3, 6):
            kinds.append(_kind(exp, captured, lambda: train(i)))
        runs.append((kinds, losses, vals, exp))
    (ek, el, ev, eexp), (gk, gl, gv, gexp) = runs
    assert ek == ["eager"] * 9 and eexp.replays == 0
    assert gk == ["eager", "capture", "replay", "eager", "capture",
                  "replay", "replay", "replay", "replay"]
    assert gexp.replays == 7
    loss = torch.cat([t[0] for t in gl])
    assert len(set(loss.tolist())) == loss.numel() == 6
    for a, w in zip(gl + gv, el + ev):
        assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])
    got = dict(gexp.model.named_parameters())
    for name, p in eexp.model.named_parameters():
        assert torch.equal(got[name], p), name
        st, want = gexp.optimizer.state[got[name]], eexp.optimizer.state[p]
        assert set(st) == set(want), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], want[key]), (name, key)


@pytest.mark.parametrize("change", ["batch", "windows", "compute_dtype"])
def test_a_changed_per_seed_key_warms_up_and_captures_again(
        tiny_data, mocap_case, change):
    """After another batch size, an epoch's new windows (EGNO's index
    arrays, drawn anew), or the bf16 forward, the next step runs eagerly,
    the one after captures anew (the old graph freed), and later ones
    replay."""
    exp, captured, (ds, windows), _, b = _setup("egno", tiny_data,
                                                 mocap_case, True)
    state = dict(windows=windows, perm=_perm(len(ds), 6, b))

    def train(i):
        exp.train_epoch(ds, state["windows"], state["perm"][i:i + 1])

    kinds = [_kind(exp, captured, lambda: train(i)) for i in range(3)]
    old = exp._steps.graphs["train"]
    if change == "batch":
        state["perm"] = _perm(len(ds), 6, b // 2)
    elif change == "windows":
        state["windows"] = exp.windows(ds, None, 3)
    else:
        exp.compute_dtype = torch.bfloat16
    kinds += [_kind(exp, captured, lambda: train(i)) for i in range(3, 6)]
    assert kinds == ["eager", "capture", "replay"] * 2
    assert exp._steps.graphs["train"] is not old
    assert captured[0] != captured[1]


@pytest.mark.parametrize("model", MODELS)
def test_the_per_seed_key_holds_the_grad_mode_and_the_compute_dtype(
        tiny_data, mocap_case, model):
    exp, _, (ds, windows), _, b = _setup(model, tiny_data, mocap_case, True)
    idx = torch.arange(b)

    def key(i=idx):
        return exp._key(ds, windows, 0, i)

    with torch.no_grad():
        off = key()
    on = key()
    exp.compute_dtype = torch.bfloat16
    assert None not in (off, on) and len({off, on, key()}) == 3
    assert key(idx[:2]) != key()


@pytest.mark.parametrize("case", ["cpu", "mesh", "segno_frames"])
def test_the_cpu_a_mesh_and_per_batch_frames_stay_eager(
        tiny_data, mocap_case, monkeypatch, case):
    """On the CPU no step is graphed; with a mesh (one rank here) the step
    and its sums over the world stay eager, and give the loop's losses
    without a mesh; SEGNO's windows drawn per batch (other input frames a
    batch, as with varDT) give every step a key of its own, and none is
    captured."""
    model = "segno" if case == "segno_frames" else "egno"
    exp, captured, (ds, windows), _, b = _setup(model, tiny_data, mocap_case,
                                                case != "cpu")
    perm = _perm(len(ds), 3, b)
    if case == "segno_frames":
        windows = np.array([[ds.start - i] for i in range(len(perm))])
    elif case == "mesh":
        monkeypatch.setattr(meshes.dist, "all_reduce",
                            lambda t, group=None: None)  # a world of one
        exp.mesh = meshes.Mesh(1, 1, 0, torch.device("cpu"), "gloo", None,
                               None, None)
    got = [exp.train_epoch(ds, windows, perm) for _ in range(2)]
    assert exp.replays == 0 and not captured and not exp._steps.graphs
    if case == "mesh":
        plain, *_ = _setup(model, tiny_data, mocap_case, False)
        want = [plain.train_epoch(ds, windows, perm) for _ in range(2)]
        for a, w in zip(got, want):
            assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])


def test_the_graph_layer_names_no_model_and_no_window_type():
    """train/graphs.py keys a step on what its experiment says the step
    bakes in of the windows (``_window_key``): its source names no model
    (nor the mocap experiment) and no window type (numpy's arrays, dicts),
    and tests the type of nothing but the dataset's tensors."""
    src = (REPO / "nonode_tpu_torch" / "train" / "graphs.py").read_text()
    models = [m.stem for m in (REPO / "nonode_tpu_torch" / "models")
              .glob("*.py") if m.stem != "__init__"] + ["mocap", "motion"]
    assert len(models) >= 4
    for name in models:
        assert name not in src.lower(), name
    tree = ast.parse(src)
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert not names & {"np", "numpy", "ndarray", "dict", "windows"}
    typed = [ast.unparse(n) for n in ast.walk(tree)
             if isinstance(n, ast.Call) and ast.unparse(n.func) == "isinstance"]
    assert typed == ["isinstance(t, torch.Tensor)"]
