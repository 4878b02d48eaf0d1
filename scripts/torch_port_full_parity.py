"""Full-size CPU parity of the port's EGNO test rollout against nonode_tpu.

    JAX_PLATFORMS=cpu python scripts/torch_port_full_parity.py [--data_dir data]

Initialises the canonical EGNO (model_confs.yaml:EGNO) with
``EGNO().init(PRNGKey(42))`` in JAX, copies the weights into
nonode_tpu_torch through compat.params, and runs both packages'
``test_rollout`` on the committed charged-5 test split (batch 256,
traj_len 20) on the CPU. Prints test_loss, avg_num_steps and
finite_fraction of both, and per window the largest difference between
their predictions over the entries finite in both. Takes about two minutes.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
jax.config.update("jax_platforms", "cpu")

from nonode_tpu.data.nbody import NBodyDataset as JaxDataset  # noqa: E402
from nonode_tpu.models.egno import EGNO as JaxEGNO  # noqa: E402
from nonode_tpu.train.loop import EGNOExperiment as JaxExperiment  # noqa: E402
from nonode_tpu_torch.compat.params import \
    egno_state_dict_from_jax_params  # noqa: E402
from nonode_tpu_torch.data.nbody import NBodyDataset  # noqa: E402
from nonode_tpu_torch.models.egno import EGNO  # noqa: E402
from nonode_tpu_torch.train.loop import EGNOExperiment  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", type=Path, default=Path("data"))
    args = ap.parse_args(argv)
    jm = JaxEGNO()
    params = jm.init(jax.random.PRNGKey(42))
    model = EGNO(device="cpu")
    model.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), jm.n_layers), strict=True)

    t0 = time.time()
    ds = NBodyDataset(args.data_dir, partition="test", traj_len=20,
                      device="cpu")
    loss, steps, art = EGNOExperiment(model).test_rollout(
        ds, 256, np.random.RandomState(42))
    print(f"port: test_loss {loss} avg_num_steps {steps} finite_fraction "
          f"{art['finite_fraction']} ({time.time() - t0:.1f} s)")
    t0 = time.time()
    jds = JaxDataset(args.data_dir, partition="test", traj_len=20)
    jloss, jsteps, jart = JaxExperiment(jm).test_rollout(
        params, jds, 256, np.random.RandomState(42))
    print(f"jax:  test_loss {jloss} avg_num_steps {jsteps} finite_fraction "
          f"{jart['finite_fraction']} ({time.time() - t0:.1f} s)")
    for w in range(art["preds"].shape[1] // 10):
        a = art["preds"][:, 10 * w:10 * (w + 1)]
        b = jart["preds"][:, 10 * w:10 * (w + 1)]
        fin = np.isfinite(a) & np.isfinite(b)
        if not fin.any():
            print(f"window {w}: no entry finite in both")
            continue
        with np.errstate(invalid="ignore", over="ignore"):
            diff = float(np.abs(a - b)[fin].max())
        print(f"window {w}: max abs diff {diff:.6g}, max |x| "
              f"{float(np.abs(b[fin]).max()):.6g}")


if __name__ == "__main__":
    main()
