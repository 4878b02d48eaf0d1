"""Helpers shared by the tests of nonode_tpu_torch: numpy arrays and JAX
parameter trees into the port's tensors and state_dict names."""

import numpy as np
import torch


def t(a):
    """A numpy (or JAX) array as a float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def mlp_sd(prefix, p):
    out = {}
    for k, name in (("l1", "0"), ("l2", "2")):
        out[f"{prefix}.{name}.weight"] = t(p[k]["w"])
        out[f"{prefix}.{name}.bias"] = t(p[k]["b"])
    return out


def egnn_layer_sd(lp):
    """A JAX EGNNLayer parameter tree as the port's EGNNLayer state_dict."""
    sd = {}
    sd.update(mlp_sd("edge_message_net.scalar_net.mlp", lp["edge_net"]))
    sd.update(mlp_sd("coord_net.mlp", lp["coord_net"]))
    for name in ("node_v_net", "node_net"):
        if name in lp:
            sd.update(mlp_sd(f"{name}.mlp", lp[name]))
    return sd


def assert_close(actual, expected, rtol, atol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol)


def write_charged_split(d, partition="test", seed=0, s=8, f=55, n=5):
    """A tiny charged split in the reference ``.npy`` layout (loc/vel stored
    [S, F, 3, N]): a random walk of positions, random velocities, +-1
    charges."""
    rng = np.random.RandomState(seed)
    steps = 0.05 * rng.randn(s, f, n, 3)
    loc = np.cumsum(steps, axis=1) + rng.randn(s, 1, n, 3)
    vel = rng.randn(s, f, n, 3) * 0.3
    charges = rng.choice([-1.0, 1.0], (s, n, 1))
    suffix = f"{partition}_charged{n}_initvel1small"
    np.save(d / f"loc_{suffix}.npy",
            loc.transpose(0, 1, 3, 2).astype(np.float32))
    np.save(d / f"vel_{suffix}.npy",
            vel.transpose(0, 1, 3, 2).astype(np.float32))
    np.save(d / f"charges_{suffix}.npy", charges.astype(np.float32))
    np.save(d / f"edges_{suffix}.npy",
            np.einsum("sik,sjk->sij", charges, charges).astype(np.float32))


def write_gravity_split(d, partition="test", seed=0, s=8, f=55, n=5):
    """A tiny gravity split in the reference ``.npy`` layout: loc/vel stored
    [S, F, N, 3] (no transpose), positive masses in the ``charges`` file and
    per-frame forces in the ``edges`` file."""
    rng = np.random.RandomState(seed)
    steps = 0.05 * rng.randn(s, f, n, 3)
    loc = np.cumsum(steps, axis=1) + rng.randn(s, 1, n, 3)
    vel = rng.randn(s, f, n, 3) * 0.3
    masses = 1.0 + 0.1 * rng.randn(s, n, 1)
    forces = rng.randn(s, f, n, 3)
    suffix = f"{partition}_gravity{n}_initvel1small"
    for name, a in (("loc", loc), ("vel", vel), ("charges", masses),
                    ("edges", forces)):
        np.save(d / f"{name}_{suffix}.npy", a.astype(np.float32))


def egno_epoch_on_rank(mesh, state, model_kw, split_kw, windows, perm, lr,
                       weight_decay):
    """One EGNO training epoch (``perm``'s rows on ``windows``) through the
    mesh on this rank, from the weights ``state`` (numpy, by name), on the
    train split NBodyDataset reads with ``split_kw``; returns the weights
    after it as numpy arrays. Run by ``parallel.mesh.launch``."""
    from nonode_tpu_torch.data.nbody import NBodyDataset
    from nonode_tpu_torch.models.egno import EGNO
    from nonode_tpu_torch.parallel.mesh import apply_mesh
    from nonode_tpu_torch.train.loop import EGNOExperiment

    model = EGNO(**model_kw, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
    exp = apply_mesh(EGNOExperiment(model, lr=lr, weight_decay=weight_decay),
                     mesh)
    exp.train_epoch(NBodyDataset(**split_kw, device="cpu"), windows, perm)
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}
