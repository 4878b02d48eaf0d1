"""nonode_tpu_torch.sim against the JAX package: the dense simulators, the
large-N simulators on the kernels' plain versions, and the dataset writer.

A seeded port run draws other initial states than JAX's threefry keys, so
the trajectories are compared from one state: JAX's ``_init_state(key)``,
handed to the port's ``integrate`` as numpy. Tolerances:
- dense simulators, N=5, T=1000, freq 100: atol 2e-4 x max|x| of each
  saved array (positions, velocities, gravity's forces), fp32 in another
  order over 1000 steps of a chaotic system;
- energy on the same frames rtol 1e-5 (one fp32 sum of N^2 terms);
- ``_clamp_walls`` exactly (selects and one subtraction);
- large-N simulators against JAX's ``interpret=True`` classes at
  tests/test_large_sim.py's tolerances (N=20 charged: positions atol 2e-4 x
  scale; N=40 gravity: positions atol 2e-4 x scale, velocities 2e-3).
The writer is held to the JAX CLI's file names, shapes, dtypes and layouts;
the contents differ by generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.sim import generate as jgen
from nonode_tpu.sim import simulators as jsim
from nonode_tpu.sim.large import LargeNChargedSim as JaxLargeCharged
from nonode_tpu.sim.large import LargeNGravitySim as JaxLargeGravity
from nonode_tpu_torch.ops.kernels import KERNELS, nbody_sim, pairwise
from nonode_tpu_torch.sim import generate, simulators
from nonode_tpu_torch.sim.large import LargeNChargedSim, LargeNGravitySim
from torch_port_util import assert_close, t

NAMES = ("charged", "springs", "gravity")


def _state(jax_state):
    return tuple(None if a is None else t(a) for a in jax_state)


def _close_by_scale(got, want, frac):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert_close(got, want, rtol=0.0, atol=frac * float(np.abs(want).max()))


@pytest.mark.parametrize("name", NAMES)
def test_dense_simulator_matches_jax_from_its_initial_state(name):
    key = jax.random.PRNGKey(3)
    jax_sim = jsim.SIM_REGISTRY[name](n_balls=5)
    want = jax_sim.sample_trajectory(key, 1000, 100)
    sim = simulators.SIM_REGISTRY[name](n_balls=5)
    got = sim.integrate(_state(jax_sim._init_state(key)), 1000, 100)
    frames = 10 if name == "gravity" else 9
    assert got[0].shape == (frames, 5, 3)
    for g, w in zip(got[:sim._TRAJECTORIES], want):
        _close_by_scale(g, w, 2e-4)
    for g, w in zip(got[sim._TRAJECTORIES:], want[sim._TRAJECTORIES:]):
        if w is None:
            assert g is None
        else:      # JAX's jitted and eager initial states differ by an ulp
            assert_close(g, w, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("name", NAMES)
def test_energy_matches_jax(name):
    key = jax.random.PRNGKey(4)
    jax_sim = jsim.SIM_REGISTRY[name](n_balls=5)
    out = jax_sim.sample_trajectory(key, 500, 100)
    sim = simulators.SIM_REGISTRY[name](n_balls=5)
    third = out[3] if name == "gravity" else out[2]        # mass or edges
    for f in range(out[0].shape[0]):
        want = jax_sim.energy(out[0][f], out[1][f], third)
        got = sim.energy(t(out[0][f]), t(out[1][f]), t(third))
        assert_close(got, want, rtol=1e-5, atol=0.0)
    # batched frames give the per-frame energies
    batched = sim.energy(t(out[0]), t(out[1]), t(third))
    assert batched.shape == (out[0].shape[0],)
    assert_close(batched[-1], jax_sim.energy(out[0][-1], out[1][-1], third),
                 rtol=1e-5, atol=0.0)


def test_clamp_walls_matches_jax_exactly():
    rng = np.random.RandomState(5)
    loc = (8.0 * rng.randn(6, 7, 3)).astype(np.float32)
    vel = rng.randn(6, 7, 3).astype(np.float32)
    wl, wv = jsim._clamp_walls(jnp.asarray(loc), jnp.asarray(vel), 5.0)
    gl, gv = simulators._clamp_walls(t(loc), t(vel), 5.0)
    assert (np.abs(loc) > 15.0).any()          # reflected once, not folded in
    assert_close(gl, wl, rtol=0.0, atol=0.0)
    assert_close(gv, wv, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("name", NAMES)
def test_initial_state_is_seeded_on_the_cpu(name):
    sim = simulators.SIM_REGISTRY[name](n_balls=6)
    a = sim.init_state(torch.Generator().manual_seed(7), batch=4)
    b = sim.init_state(torch.Generator().manual_seed(7), batch=4)
    for x, y in zip(a, b):
        assert (x is None and y is None) or (
            x.device.type == "cpu" and torch.equal(x, y))
    assert a[0].shape == (4, 6, 3) and a[1].shape == (4, 6, 3)
    if name == "gravity":
        pos, vel, mass = a
        assert mass.shape == (4, 6, 1) and (mass > 0).all()
        momentum = (mass * vel).sum(-2)                 # the CoM frame
        assert float(momentum.abs().max()) < 1e-5
    else:
        loc, vel, edges, charges = a
        speed = torch.linalg.vector_norm(vel, dim=-1)
        assert_close(speed, np.full((4, 6), 0.5, np.float32), rtol=1e-6,
                     atol=0.0)
        assert float(loc.abs().max()) <= 3 * 5.0
        assert torch.equal(edges, edges.transpose(-1, -2))
        assert float(torch.diagonal(edges, dim1=-2, dim2=-1).abs().max()) \
            == (1.0 if name == "charged" else 0.0)
        if name == "charged":
            assert set(charges.unique().tolist()) <= {-1.0, 1.0}
            assert torch.equal(edges, charges @ charges.transpose(-1, -2))
        else:
            assert charges is None


def test_loc_std_scales_with_the_particle_count():
    for n in (5, 40, 1000):
        assert simulators.ChargedSim(n_balls=n)._loc_std == pytest.approx(
            jsim.ChargedSim(n_balls=n)._loc_std, rel=1e-12)


def test_batch_matches_single_trajectories():
    """The batch dimension stands in for vmap: trajectory b of a batch is
    the trajectory of state b alone."""
    sim = simulators.GravitySim(n_balls=5)
    state = sim.init_state(torch.Generator().manual_seed(8), batch=3)
    batched = sim.integrate(state, 500, 100)
    for b in range(3):
        single = sim.integrate(tuple(a[b] for a in state), 500, 100)
        for x, y in zip(batched, single):
            assert_close(x[b], y, rtol=0.0, atol=1e-6 * float(y.abs().max()))


def test_noise_is_drawn_only_when_asked():
    clean = simulators.ChargedSim(n_balls=5).sample_trajectory(
        torch.Generator().manual_seed(0), 1000, 100, device="cpu")
    again = simulators.ChargedSim(n_balls=5).sample_trajectory(
        torch.Generator().manual_seed(0), 1000, 100, device="cpu")
    noisy = simulators.ChargedSim(n_balls=5, noise_var=0.1).sample_trajectory(
        torch.Generator().manual_seed(0), 1000, 100, device="cpu")
    assert torch.equal(clean[0], again[0])
    assert torch.equal(clean[2], noisy[2])                 # same edges
    d = (noisy[0] - clean[0]).abs().mean()
    assert 0.01 < float(d) < 0.5


def test_sample_batch_shapes_and_the_device_rule(monkeypatch):
    out = simulators.sample_batch(simulators.GravitySim(n_balls=4),
                                  torch.Generator().manual_seed(1), 2, 300,
                                  100, device="cpu")
    assert [tuple(a.shape) for a in out] == [(2, 3, 4, 3)] * 3 + [(2, 4, 1)]
    with pytest.raises(ValueError, match="multiple of sample_freq"):
        simulators.ChargedSim().integrate(
            simulators.ChargedSim().init_state(torch.Generator()), 250, 100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulators.SpringSim().sample_trajectory(torch.Generator(), 200, 100)


def test_large_n_charged_matches_jax_interpret():
    key = jax.random.PRNGKey(1)
    n, T, freq = 20, 300, 100
    big = JaxLargeCharged(n_balls=n, interpret=True)
    l1, v1, e1, q1 = big.sample_trajectory(key, T=T, sample_freq=freq)
    before = [k["wrapper"].launches for k in KERNELS]
    l2, v2, e2, q2 = LargeNChargedSim(n_balls=n).integrate(
        _state(big._init_state(key)), T, freq)
    assert [k["wrapper"].launches for k in KERNELS] == before  # plain, CPU
    assert l2.shape == (2, n, 3)
    assert_close(q2, q1, rtol=0.0, atol=0.0)
    _close_by_scale(l2, l1, 2e-4)
    _close_by_scale(v2, v1, 2e-4)


def test_large_n_charged_matches_jax_interpret_at_every_step():
    """sample_freq 1: every frame is a block of one recorded micro-step
    (the JAX class runs no block, only the drift, force and kick)."""
    key = jax.random.PRNGKey(2)
    n, T = 20, 20
    big = JaxLargeCharged(n_balls=n, interpret=True)
    l1, v1, _, _ = big.sample_trajectory(key, T=T, sample_freq=1)
    l2, v2, _, _ = LargeNChargedSim(n_balls=n).integrate(
        _state(big._init_state(key)), T, 1)
    assert l2.shape == (T - 1, n, 3)
    _close_by_scale(l2, l1, 2e-4)
    _close_by_scale(v2, v1, 2e-4)


def _unfused_charged_frames(sim, state, T, freq):
    """The charged frame loop before each frame became one recorded block:
    freq - 1 fused steps, then the drift, the record, a force evaluation and
    the kick (the loop of nonode_tpu/sim/large.py), on the plain versions."""
    loc, vel, _, charges = state
    kw = dict(k=sim.interaction_strength, max_f=sim._max_f)
    vel = vel + sim.dt * pairwise.charged_force_reference(loc, charges, **kw)
    locs, vels = [], []
    for _ in range(T // freq - 1):
        if freq > 1:
            loc, vel = nbody_sim.charged_leapfrog_reference(
                loc, vel, charges, freq - 1, sim.dt, **kw)
        loc = loc + sim.dt * vel
        locs.append(loc)
        vels.append(vel)
        vel = vel + sim.dt * pairwise.charged_force_reference(loc, charges,
                                                              **kw)
    return torch.stack(locs), torch.stack(vels)


@pytest.mark.parametrize("T,freq", [(300, 100), (12, 3), (6, 1)])
def test_large_n_charged_is_the_unfused_frame_loop_exactly(T, freq):
    sim = LargeNChargedSim(n_balls=11)
    state = sim.init_state(torch.Generator().manual_seed(freq))
    got = sim.integrate(state, T, freq)
    want = _unfused_charged_frames(sim, state, T, freq)
    assert got[0].shape == (T // freq - 1, 11, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] is state[2] and got[3] is state[3]


def test_large_n_gravity_matches_jax_interpret():
    key = jax.random.PRNGKey(0)
    n, T, freq = 40, 300, 100
    big = JaxLargeGravity(n_balls=n, interpret=True)
    p1, v1, f1, m1 = big.sample_trajectory(key, T=T, sample_freq=freq)
    p2, v2, f2, m2 = LargeNGravitySim(n_balls=n).integrate(
        _state(big._init_state(key)), T, freq)
    assert p2.shape == (3, n, 3)
    assert_close(m2, m1, rtol=1e-6, atol=0.0)
    scale = float(jnp.abs(p1).max())
    assert_close(p2, p1, rtol=0.0, atol=2e-4 * scale)
    assert_close(v2, v1, rtol=0.0, atol=2e-3)
    _close_by_scale(f2, f1, 2e-4)


def test_large_n_simulators_match_the_dense_ones():
    """The port's two routes from one seeded state (the card repeats this in
    chip_smoke.py)."""
    sim, big = simulators.ChargedSim(n_balls=12), LargeNChargedSim(n_balls=12)
    state = sim.init_state(torch.Generator().manual_seed(2))
    _close_by_scale(big.integrate(state, 300, 100)[0],
                    sim.integrate(state, 300, 100)[0], 2e-4)
    gsim, gbig = simulators.GravitySim(n_balls=16), LargeNGravitySim(
        n_balls=16)
    state = gsim.init_state(torch.Generator().manual_seed(3))
    dense, large = gsim.integrate(state, 300, 100), gbig.integrate(state, 300,
                                                                    100)
    _close_by_scale(large[0], dense[0], 2e-4)
    assert_close(large[1], dense[1], rtol=0.0, atol=2e-3)
    with pytest.raises(ValueError, match="one \\[N, 3\\] system"):
        big.integrate(sim.init_state(torch.Generator(), batch=2), 300, 100)


@pytest.mark.parametrize("name", NAMES)
def test_generate_writes_the_jax_layouts(tmp_path, name):
    argv = ["--simulation", name, "--num-train", "3", "--num-valid", "2",
            "--num-test", "2", "--length", "300", "--length_test", "400",
            "--n_balls", "4", "--suffix", "tiny", "--chunk", "2",
            "--initial_vel", "0"]
    jgen.main(jgen.get_args(argv + ["--outdir", str(tmp_path / "jax")]))
    args = generate.get_args(argv + ["--outdir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    assert args.device == "cpu" and generate.get_args([]).device == "cuda"
    generate.main(args)
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    pfiles = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert pfiles == jfiles and len(pfiles) == 12
    for f in jfiles:
        want = np.load(tmp_path / "jax" / f)
        got = np.load(tmp_path / "port" / f)
        assert (got.shape, got.dtype) == (want.shape, want.dtype), f
    s = f"_{name}4_initvel0tiny.npy"
    loc = np.load(tmp_path / "port" / f"loc_test{s}")
    charges = np.load(tmp_path / "port" / f"charges_train{s}")
    vel = np.load(tmp_path / "port" / f"vel_train{s}")
    if name == "gravity":
        assert loc.shape == (2, 4, 4, 3)                 # [S, T, N, 3]
        assert (charges > 0).all()                       # masses
        forces = np.load(tmp_path / "port" / f"edges_train{s}")
        assert forces.shape == (3, 3, 4, 3)
        assert np.abs(vel).max() > 0.1                   # vel_norm unused
    else:
        assert loc.shape == (2, 3, 3, 4)                 # [S, T, 3, N]
        if name == "springs":
            assert charges.min() == charges.max() == 1.0
            speed = np.linalg.norm(vel[:, 0], axis=1)
            assert speed.mean() > 0.05                   # --initial_vel unused
        else:
            assert set(np.unique(charges)) <= {-1.0, 1.0}
