"""The plain reference (``h100_bench/reference``) against the program,
``nonode_tpu_torch``, at a tiny size on the CPU, where the program runs
the plain versions of its kernels: the same weights and inputs give the
same forward, loss, gradients, Adam-L2 steps and rollout, within float32
reordering. The reference itself imports nothing of the program
(test_h100_imports.py)."""

import numpy as np
import pytest
import torch

from h100_bench import inputs, splits
from h100_bench.reference import common, egno, segno

from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.main import build_experiment, get_args

# float32 sums of a few hundred terms in another order, through 4 layers
# (EGNO) or 10 steps (SEGNO): the gaps read 1e-7 to 1e-6
RTOL = 2e-5
CFG = {"egno": dict(num_timesteps=10, num_modes=2, nf=16, in_edge_nf=2,
                    in_node_nf=2, time_emb_dim=8, n_layers=2, frame_0=30,
                    traj_len=3, n_balls=5),
       "segno": dict(num_timesteps=10, nf=16, in_edge_nf=2, in_node_nf=1,
                     recurrent=True, frame_0=30, traj_len=3, n_balls=5)}
DATA = dict(n_balls=5, loc_std=1.0, vel_norm=0.5, box_size=5.0, dt=0.001,
            interaction_strength=1.0, sample_freq=100, num_train=24,
            num_valid=0, num_test=16, length=4200, length_test=6200,
            dataset="charged")
REF = {"egno": egno, "segno": segno}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Tiny charged splits in the program's file layout, and their host
    arrays for the reference."""
    d = tmp_path_factory.mktemp("splits")
    sim = splits.simulate(DATA, torch.Generator().manual_seed(7),
                          torch.device("cpu"))
    sim = {k: v for k, v in sim.items() if k != "valid"}
    return d, splits.write(sim, DATA, d)


def _program(model, tmp_path, data_dir):
    cfg = CFG[model]
    preset = tmp_path / f"{model}.json"
    preset.write_text(
        '{"nf": %d, "n_layers": %d, "time_emb_dim": %d, "traj_len": %d}'
        % (cfg["nf"], cfg.get("n_layers", 1), cfg.get("time_emb_dim", 32),
           cfg["traj_len"]))
    args = get_args(["--model", model, "--device", "cpu", "--data_dir",
                     str(data_dir), "--config_by_file", str(preset)])
    return args, build_experiment(args, torch.device("cpu"),
                                  torch.Generator().manual_seed(0))


def _weights(model, exp):
    """The benchmark's weights for the reference's specs, loaded into the
    program's model; the names and shapes must be the program's."""
    w = REF[model].draw_weights(CFG[model], 1,
                                torch.Generator().manual_seed(3),
                                torch.device("cpu"))
    w = {n: t[0] for n, t in w.items()}
    exp.model.load_state_dict(w, strict=True)
    return w


def _split(host, name):
    loc, vel, charges = host[name]
    return {"loc": torch.from_numpy(loc), "vel": torch.from_numpy(vel),
            "charges": torch.from_numpy(charges)}


def _close(a, b, rtol=RTOL):
    a = torch.as_tensor(np.asarray(a, np.float64))
    b = torch.as_tensor(np.asarray(b, np.float64))
    assert a.shape == b.shape
    scale = max(1.0, float(b.abs().max()))
    assert float((a - b).abs().max()) <= rtol * scale


@pytest.mark.parametrize("model", ["egno", "segno"])
def test_params_match_the_program_and_its_init_bounds(model, tmp_path, data):
    _, exp = _program(model, tmp_path, data[0])
    specs = REF[model].param_specs(CFG[model])
    state = exp.model.state_dict()
    assert [s[0] for s in specs] == list(state)
    for name, shape, low, high in specs:
        assert tuple(state[name].shape) == shape
        # the program's own init draws inside the same bounds
        assert low <= float(state[name].min()) and \
            float(state[name].max()) <= high


@pytest.mark.parametrize("model", ["egno", "segno"])
def test_loss_and_gradients_match_the_program(model, tmp_path, data):
    args, exp = _program(model, tmp_path, data[0])
    w = _weights(model, exp)
    ds = NBodyDataset(data[0], partition="train", device="cpu",
                      num_timesteps=10)
    perm, windows = exp.draw_epoch(ds, np.random.RandomState(0), 8)
    idx = torch.from_numpy(perm[0])
    got, got_frames = exp._loss(exp.batch(ds, windows, 0, idx))
    p = {n: t.clone().requires_grad_() for n, t in w.items()}
    want, want_frames = REF[model].train_loss(p, CFG[model],
                                              _split(data[1], "train"), idx)
    _close(got.item(), want.item())
    _close(got_frames.detach(), want_frames.detach())
    g_got = torch.autograd.grad(got, list(exp.model.parameters()),
                                allow_unused=True)
    g_want = torch.autograd.grad(want, list(p.values()), allow_unused=True)
    for (name, _), a, b in zip(exp.model.named_parameters(), g_got, g_want):
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, 1e-4)


def test_adam_l2_steps_match_torch_adam():
    gen = torch.Generator().manual_seed(1)
    p0 = {"a": torch.randn(4, 3, generator=gen),
          "b": torch.randn(5, generator=gen)}
    params = [p0["a"].clone().requires_grad_(),
              p0["b"].clone().requires_grad_()]
    opt = torch.optim.Adam(params, lr=1e-2, weight_decay=1e-3)
    ref = common.AdamL2(p0, 1e-2, 1e-3)
    p = dict(p0)
    for step in range(3):
        grads = {"a": torch.randn(4, 3, generator=gen),
                 "b": None if step == 1 else torch.randn(5, generator=gen)}
        for t, g in zip(params, grads.values()):
            t.grad = torch.zeros_like(t) if g is None else g.clone()
        opt.step()
        p = ref.step(p, grads)
        for t, (n, r) in zip(params, p.items()):
            _close(t.detach(), r, 1e-6)


@pytest.mark.parametrize("model", ["egno", "segno"])
def test_rollout_matches_the_programs_test_evaluation(model, tmp_path, data):
    args, exp = _program(model, tmp_path, data[0])
    w = _weights(model, exp)
    ds = NBodyDataset(data[0], partition="test", device="cpu",
                      num_timesteps=10, traj_len=CFG[model]["traj_len"])
    _, _, art = exp.test_rollout(ds, 8, np.random.RandomState(0))
    ref = REF[model]
    frames = ref.compared_frames(CFG[model])
    split = _split(data[1], "test")
    idx = torch.arange(16)
    with torch.no_grad():
        x, e, _ = ref.rollout(w, CFG[model], split, idx, frames)
    assert art["preds"].shape[1] == frames
    _close(art["preds"], x.transpose(0, 1), 1e-4)
    _close(art["energy_conservation"][..., 0], e.transpose(0, 1), 1e-4)
    _close(art["targets"][:, :frames],
           ref.truth(CFG[model], split, idx, frames).transpose(0, 1), 0)


@pytest.mark.parametrize("model", ["egno", "segno"])
def test_every_rolled_window_matches_the_programs_rollout(model, tmp_path,
                                                         data):
    """Every window the evaluation rolls out, also those past the frames
    its artifact keeps, as the program's rollout returns them."""
    args, exp = _program(model, tmp_path, data[0])
    w = _weights(model, exp)
    ds = NBodyDataset(data[0], partition="test", device="cpu",
                      num_timesteps=10, traj_len=CFG[model]["traj_len"])
    rolled, rollout = [], exp.rollout
    exp.rollout = lambda *a: rolled.append(rollout(*a)) or rolled[-1]
    exp.test_rollout(ds, 8, np.random.RandomState(0))
    ref = REF[model]
    frames = ref.rolled_frames(CFG[model])
    with torch.no_grad():
        x, e, _ = ref.rollout(w, CFG[model], _split(data[1], "test"),
                           torch.arange(16), frames)
    assert frames >= ref.compared_frames(CFG[model])
    _close(torch.cat([r[0] for r in rolled], 1), x)
    _close(torch.cat([r[1][..., 0] for r in rolled], 1), e, 1e-4)


def test_a_float64_rollout_runs_and_agrees(data):
    """The float64 witness of the checks: the same rollout in float64
    stays within float32 rounding of the float32 one at this size."""
    w = egno.draw_weights(CFG["egno"], 1, torch.Generator().manual_seed(3),
                          torch.device("cpu"))
    w = {n: t[0] for n, t in w.items()}
    split = _split(data[1], "test")
    idx = torch.arange(4)
    with torch.no_grad():
        x32, _, _ = egno.rollout(w, CFG["egno"], split, idx, 10)
        x64, _, _ = egno.rollout({n: t.double() for n, t in w.items()},
                              CFG["egno"], {k: v.double()
                                            for k, v in split.items()},
                              idx, 10)
    assert x64.dtype == torch.float64
    _close(x32, x64, 1e-5)


def test_simulated_splits_follow_the_programs_simulator(data):
    """The benchmark's charged simulation takes the port's cadence: from
    the same initial state its first frames match ``ChargedSim``'s within
    float32 rounding (later frames drift apart, the system is chaotic),
    and the program's loader reads the files it writes."""
    from nonode_tpu_torch.sim.simulators import ChargedSim

    cfg = dict(DATA, num_train=6, num_test=0, length=1100)
    sim = splits.simulate(cfg, torch.Generator().manual_seed(5),
                          torch.device("cpu"))
    loc, vel, q = splits.initial_state(cfg, 6,
                                       torch.Generator().manual_seed(5),
                                       torch.device("cpu"))
    want, want_vel, _, _ = ChargedSim(n_balls=5).integrate(
        (loc, vel, q @ q.transpose(1, 2), q), 1100, 100)
    got = sim["train"][0]
    assert got.shape == want.shape == (6, 10, 5, 3)
    _close(got[:, :3], want[:, :3], 1e-5)
    _close(sim["train"][1][:, :3], want_vel[:, :3], 1e-5)
    ds = NBodyDataset(data[0], partition="test", device="cpu", traj_len=2)
    np.testing.assert_array_equal(ds.loc.numpy(), data[1]["test"][0])
    np.testing.assert_array_equal(ds.charges.numpy(), data[1]["test"][2])


def test_streams_are_fixed_by_the_seed_and_differ_by_key():
    ctx = inputs.Context(name="c", cfg={}, cfg_path=None, params={},
                         seed=2 ** 31 + 5, device=torch.device("cpu"))
    a = inputs.host_rng(ctx, inputs.FLEET_SEED, 0).randint(1 << 30, size=4)
    b = inputs.host_rng(ctx, inputs.FLEET_SEED, 0).randint(1 << 30, size=4)
    c = inputs.host_rng(ctx, inputs.FLEET_SEED, 1).randint(1 << 30, size=4)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    g1 = inputs.generator(ctx, inputs.DATA).initial_seed()
    assert g1 == inputs.generator(ctx, inputs.DATA).initial_seed()
    assert g1 != inputs.generator(ctx, inputs.WEIGHTS).initial_seed()
