"""nonode_tpu_torch.ops.kernels.{pairwise,nbody_sim} against the JAX package.

The plain PyTorch versions of the four N-body kernels are held to the
Pallas kernels they replace, run in interpret mode on the CPU as
tests/test_pallas.py runs them: the Coulomb force and softened gravity
(nonode_tpu/ops/pallas/pairwise.py) and the fused leapfrog blocks
(ops/pallas/nbody_sim.py). The CUDA kernels themselves run only on the
card: their tests are in test_torch_cuda.py.

Tolerances: a single force evaluation rtol 1e-5, atol 1e-5 x max|F| (fp32
sums of up to 200 terms in another order, rsqrt on both sides); a block of
up to 20 micro-steps atol 1e-5 x max|pos| on the positions (the same
rounding carried through the steps), and the same relative to their own
scale on velocities and accelerations.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.ops.pallas import nbody_sim as jnbody
from nonode_tpu.ops.pallas import pairwise as jpair
from nonode_tpu_torch.ops.kernels import KERNELS, build, nbody_sim, pairwise
from torch_port_util import assert_close, t

REPO = Path(__file__).resolve().parents[1]


def _bodies(n, seed, charged=True):
    rng = np.random.RandomState(seed)
    pos = rng.randn(n, 3).astype(np.float32)
    w = (rng.choice([-1.0, 1.0], n) if charged
         else 1.0 + 0.1 * rng.randn(n)).astype(np.float32)
    return pos, w


def _close_scaled(got, want, rel):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert_close(got, want, rtol=1e-5 if rel else 0.0, atol=1e-5 * scale)


@pytest.mark.parametrize("block_i", [256, 64, 100])
@pytest.mark.parametrize("n", [5, 129, 200])
def test_charged_force_plain_version_matches_pallas(n, block_i):
    """block_i 64 and 100 do not divide the padded width (the tail-block
    case of tests/test_pallas.py:76-90)."""
    pos, q = _bodies(n, seed=n)
    want = jpair.charged_force(jnp.asarray(pos), jnp.asarray(q),
                               block_i=block_i, interpret=True)
    got = pairwise.charged_force_reference(t(pos), t(q))
    _close_scaled(got, want, rel=True)


def test_charged_force_clips_and_takes_column_charges():
    """Two bodies 1e-3 apart: every force component beyond +-max_f is cut;
    charges as [N, 1] as the simulators keep them."""
    pos, q = _bodies(6, seed=1)
    pos[1] = pos[0] + 1e-3
    want = jpair.charged_force(jnp.asarray(pos), jnp.asarray(q[:, None]),
                               k=2.0, max_f=50.0, interpret=True)
    got = pairwise.charged_force_reference(t(pos), t(q[:, None]), k=2.0,
                                           max_f=50.0)
    assert float(got.abs().max()) == 50.0
    _close_scaled(got, want, rel=True)


def test_charged_force_padding_does_not_leak():
    """tests/test_pallas.py:56-73 for the port: a far body of charge 0 adds
    nothing, and dropping bodies does change the forces."""
    pos, q = _bodies(130, seed=2)
    full = pairwise.charged_force_reference(t(pos), t(q))
    padded = pairwise.charged_force_reference(
        t(np.concatenate([pos, np.full((1, 3), 99.0, np.float32)])),
        t(np.concatenate([q, np.zeros(1, np.float32)])))[:130]
    sub = pairwise.charged_force_reference(t(pos[:128]), t(q[:128]))
    assert_close(padded, full, rtol=0.0, atol=1e-5)
    assert not np.allclose(full[:128].numpy(), sub.numpy())
    want = jpair.charged_force(jnp.asarray(pos), jnp.asarray(q),
                               interpret=True)
    _close_scaled(full, want, rel=True)


@pytest.mark.parametrize("block_i", [256, 64, 129])
@pytest.mark.parametrize("n", [5, 129, 200])
def test_gravity_accel_plain_version_matches_pallas(n, block_i):
    pos, m = _bodies(n, seed=n + 7, charged=False)
    want = jpair.gravity_accel(jnp.asarray(pos), jnp.asarray(m),
                               block_i=block_i, interpret=True)
    got = pairwise.gravity_accel_reference(t(pos), t(m))
    _close_scaled(got, want, rel=True)
    dense = jpair.pairwise_accel_reference(jnp.asarray(pos), jnp.asarray(m))
    _close_scaled(got, dense, rel=True)


def test_gravity_accel_constants_and_massless_body():
    """G and the softening reach the sum; a body of mass 0 pulls nothing."""
    pos, m = _bodies(9, seed=3, charged=False)
    m[4] = 0.0
    want = jpair.gravity_accel(jnp.asarray(pos), jnp.asarray(m[:, None]),
                               g=0.5, softening=0.3, interpret=True)
    got = pairwise.gravity_accel_reference(t(pos), t(m[:, None]), g=0.5,
                                           softening=0.3)
    _close_scaled(got, want, rel=True)
    moved = pos.copy()
    moved[4] += 10.0
    assert torch.equal(got[[0, 1, 2]], pairwise.gravity_accel_reference(
        t(moved), t(m[:, None]), g=0.5, softening=0.3)[[0, 1, 2]])


@pytest.mark.parametrize("n,steps", [(5, 20), (129, 7), (1, 3)])
def test_charged_leapfrog_plain_version_matches_pallas(n, steps):
    pos, q = _bodies(n, seed=n + 11)
    vel = (0.3 * np.random.RandomState(n).randn(n, 3)).astype(np.float32)
    jp, jv = jnbody.charged_leapfrog_block(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(q), steps=steps,
        interpret=True)
    tp, tv = nbody_sim.charged_leapfrog_reference(t(pos), t(vel), t(q), steps)
    _close_scaled(tp, jp, rel=False)
    _close_scaled(tv, jv, rel=False)


@pytest.mark.parametrize("n,steps", [(5, 20), (129, 7), (1, 3)])
def test_gravity_leapfrog_plain_version_matches_pallas(n, steps):
    pos, m = _bodies(n, seed=n + 13, charged=False)
    rng = np.random.RandomState(n)
    vel = (0.3 * rng.randn(n, 3)).astype(np.float32)
    acc = np.asarray(jpair.pairwise_accel_reference(jnp.asarray(pos),
                                                    jnp.asarray(m)))
    jp, jv, ja = jnbody.gravity_leapfrog_block(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc), jnp.asarray(m),
        steps=steps, dt=0.002, interpret=True)
    tp, tv, ta = nbody_sim.gravity_leapfrog_reference(
        t(pos), t(vel), t(acc), t(m), steps, dt=0.002)
    _close_scaled(tp, jp, rel=False)
    _close_scaled(tv, jv, rel=False)
    _close_scaled(ta, ja, rel=False)


@pytest.mark.parametrize("f", [1, 2, 100])
def test_recorded_block_is_the_unfused_frame(f):
    """A block of f micro-steps with records gives exactly the frame that
    the simulator used to compose: f - 1 fused steps, then the drift, the
    record, a force evaluation and the kick, the same torch ops in the same
    order. Through the wrapper (the plain version on the CPU) and the plain
    version alike."""
    pos, q = _bodies(9, seed=f)
    pos, q = t(pos), t(q)
    vel = t(0.3 * np.random.RandomState(f).randn(9, 3))
    p, v = (pos, vel) if f == 1 else nbody_sim.charged_leapfrog_reference(
        pos, vel, q, f - 1)
    p = p + 0.001 * v
    want = (p, v + 0.001 * pairwise.charged_force_reference(p, q), p, v)
    for fn in (nbody_sim.charged_leapfrog,
               nbody_sim.charged_leapfrog_reference):
        rec = (torch.full((9, 3), np.nan), torch.full((9, 3), np.nan))
        got = (*fn(pos, vel, q, f, record=rec), *rec)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        # records change nothing else
        assert all(torch.equal(a, b) for a, b in zip(got, fn(pos, vel, q, f)))


@pytest.mark.parametrize("bad,error,match", [
    (lambda: torch.zeros(9, 2), ValueError, r"rec_vel has shape \(9, 2\)"),
    (lambda: torch.zeros(9, 3, dtype=torch.float64), TypeError, "float32"),
    (lambda: torch.zeros(9, 3, device="meta"), ValueError,
     "rec_vel is on meta"),
    (lambda: torch.zeros(3, 9).T, ValueError, "rec_vel is not contiguous"),
], ids=["shape", "dtype", "device", "contiguity"])
def test_wrapper_refuses_a_record_unlike_the_state(bad, error, match):
    pos, q = _bodies(9, seed=8)
    with pytest.raises(error, match=match):
        nbody_sim.charged_leapfrog(t(pos), t(pos), t(q), 3,
                                   record=(torch.zeros(9, 3), bad()))
    with pytest.raises(error):
        nbody_sim.charged_leapfrog(t(pos), t(pos), t(q), 3,
                                   record=(bad(), torch.zeros(9, 3)))


def test_wrappers_take_plain_versions_only_on_cpu():
    pos, q = _bodies(7, seed=5)
    vel = torch.zeros(7, 3)
    before = [k["wrapper"].launches for k in KERNELS]
    assert torch.equal(pairwise.charged_force(t(pos), t(q)),
                       pairwise.charged_force_reference(t(pos), t(q)))
    assert torch.equal(pairwise.gravity_accel(t(pos), t(q).abs()),
                       pairwise.gravity_accel_reference(t(pos), t(q).abs()))
    for a, b in zip(nbody_sim.charged_leapfrog(t(pos), vel, t(q), 2),
                    nbody_sim.charged_leapfrog_reference(t(pos), vel, t(q),
                                                         2)):
        assert torch.equal(a, b)
    for a, b in zip(
            nbody_sim.gravity_leapfrog(t(pos), vel, vel, t(q).abs(), 2),
            nbody_sim.gravity_leapfrog_reference(t(pos), vel, vel, t(q).abs(),
                                                 2)):
        assert torch.equal(a, b)
    assert [k["wrapper"].launches for k in KERNELS] == before  # no kernel ran
    meta = t(pos).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pairwise.charged_force(meta, t(q).to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        nbody_sim.gravity_leapfrog(meta, meta, meta, t(q).to("meta"), 1)


@pytest.mark.parametrize("steps", [0, -1, 2.5])
def test_leapfrog_refuses_fewer_than_one_step(steps):
    pos, q = _bodies(4, seed=6)
    with pytest.raises(ValueError, match="at least one micro-step"):
        nbody_sim.charged_leapfrog(t(pos), t(pos), t(q), steps)
    with pytest.raises(ValueError, match="at least one micro-step"):
        nbody_sim.gravity_leapfrog(t(pos), t(pos), t(pos), t(q), steps)


def test_launch_checks_refuse_what_the_kernels_do_not_take():
    """The checks every CUDA launch runs first (device-independent)."""
    pos, q = _bodies(4, seed=7)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        pairwise.check_bodies(t(pos).T.contiguous(), t(q))
    with pytest.raises(ValueError, match="3 charges or masses for 4 bodies"):
        pairwise.check_bodies(t(pos), t(q[:3]))
    with pytest.raises(TypeError, match="float32"):
        pairwise.check_bodies(t(pos).double(), t(q))
    with pytest.raises(ValueError, match="not contiguous"):
        pairwise.check_bodies(t(pos), t(q), vel=t(np.ones((3, 4))).T)
    with pytest.raises(ValueError, match="acc has shape"):
        pairwise.check_bodies(t(pos), t(q), acc=torch.zeros(5, 3))
    n, w = pairwise.check_bodies(t(pos), t(q[:, None]), vel=t(pos))
    assert n == 4 and tuple(w.shape) == (4,)


def test_nbody_registry_entries_point_at_tpu_kernels():
    tpu_kernel = {"nbody_charged_force": ("pairwise.py", "_charged_kernel"),
                  "nbody_gravity_accel": ("pairwise.py", "_gravity_kernel"),
                  "nbody_charged_leapfrog": ("nbody_sim.py",
                                             "_charged_block_kernel"),
                  "nbody_gravity_leapfrog": ("nbody_sim.py",
                                             "_gravity_block_kernel")}
    entries = {k["name"]: k for k in KERNELS if k["name"] in tpu_kernel}
    assert set(entries) == set(tpu_kernel)
    for name, (tpu_file, fn) in tpu_kernel.items():
        k = entries[name]
        path, line = k["replaces"].rsplit(":", 1)
        assert path == f"nonode_tpu/ops/pallas/{tpu_file}"
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(f"def {fn}("), text
        assert (REPO / k["source"]).is_file() and k["route"] == "cuda"
    # the two sources include one shared header: a change there rebuilds both
    header = REPO / "nonode_tpu_torch" / "csrc" / "nbody_pair.cuh"
    for source in (pairwise.SOURCE, nbody_sim.SOURCE):
        assert '#include "nbody_pair.cuh"' in (build.CSRC / source).read_text()
    assert header.is_file()
