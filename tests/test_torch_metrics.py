"""nonode_tpu_torch.train.metrics against nonode_tpu.train.metrics.

Tolerance 1e-5 relative: the same fp32 formulas, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nonode_tpu.train import metrics as jmet
from nonode_tpu_torch.train import metrics as tmet
from torch_port_util import assert_close, t


@pytest.mark.parametrize("dataset", ["charged", "gravity"])
def test_conserved_energy_matches_jax(dataset):
    rng = np.random.RandomState(0)
    loc = rng.randn(6, 4, 5, 3).astype(np.float32)      # [T, B, N, 3]
    vel = rng.randn(6, 4, 5, 3).astype(np.float32)
    if dataset == "charged":
        q = rng.choice([-1.0, 1.0], (4, 5, 1)).astype(np.float32)
    else:
        q = rng.uniform(0.5, 2.0, (4, 5, 1)).astype(np.float32)
    loc[0, 0, 1] = loc[0, 0, 0]      # coincident pair: the dist == 0 guard
    je = jmet.conserved_energy(dataset, *map(jnp.asarray, (loc, vel, q)))
    te = tmet.conserved_energy(dataset, *map(t, (loc, vel, q)))
    assert te.shape == (6, 4)
    assert_close(te, je, rtol=1e-5, atol=1e-5)
    assert_close(tmet.energy_drift(te), jmet.energy_drift(je),
                 rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("steps", [1, 2, 25])
def test_pearson_correlation_matches_jax(steps):
    rng = np.random.RandomState(steps)
    b, n = 6, 5
    y = rng.randn(steps, b * n, 3).astype(np.float32)
    noise = np.linspace(0.0, 3.0, steps)[:, None, None]  # correlation decays
    x = (y + noise * rng.randn(*y.shape)).astype(np.float32)
    x[:, :n] = np.nan                                    # a diverged sample
    jc, ja, jf = jmet.pearson_correlation_batch(jnp.asarray(x),
                                                jnp.asarray(y), n)
    tc, ta, tf = tmet.pearson_correlation_batch(t(x), t(y), n)
    assert tc.shape == (b, max(int(0.4 * steps), 1))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    assert int(tf) == int(jf)
