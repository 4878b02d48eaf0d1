"""CMU motion-capture datasets (counterpart of nonode_tpu/data/motion.py).

Loads the ``(edges, [X_trial])`` motion pickles, takes finite-difference
velocities (V = X[1:] - X[:-1], X cut to X[:-1]; EGNO/motion/dataset.py:
23-26), uses the fixed trial splits with their cached start frames
(dataset.py:51-80), builds the skeleton (attr 1) and 2-hop (attr 2) edges
as a dense [N, N] attribute matrix and edge mask (dataset.py:124-137), and
the z/10 node feature (dataset.py:156). Samples are float32 tensors on the
dataset's device.

The start frames are drawn as the JAX package draws them, from
``np.random.RandomState(100)`` (its global ``np.random.seed(100)``, whose
legacy ``choice`` gives the same values), here from a local state, so the
caller's global NumPy state is left as it was. The split pickle is the same
structure in both packages: either one reads what the other wrote.

``MotionDynamicsDataset`` targets the EGNO decoder: ``num_timesteps``
frames ending at ``delta_frame`` (the reference's ``last=True`` branch,
dataset.py:252-263).
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

WALK_SPLIT = {"train": [20, 1, 17, 13, 14, 9, 4, 2, 7, 5, 16],
              "val": [3, 8, 11, 12, 15, 18],
              "test": [6, 19, 21, 0, 22, 10]}
RUN_SPLIT = {"train": [1, 2, 5, 6, 10],
             "val": [0, 4, 9],
             "test": [3, 7, 8]}


def _load_case(data_dir: Path, case: str):
    name = {"walk": "motion.pkl", "run": "motion_run.pkl"}[case]
    with open(data_dir / name, "rb") as f:
        edges, x = pickle.load(f)
    v = [xi[1:] - xi[:-1] for xi in x]
    x = [xi[:-1] for xi in x]
    return edges, x, v


def _load_split(data_dir: Path, case: str):
    """(train, val, test): {trial: start frames} each. Read from the split
    pickle when it is there; else drawn and written there, or kept in memory
    when the directory cannot be written."""
    split_path = data_dir / {"walk": "split.pkl", "run": "split_run.pkl"}[case]
    if split_path.exists():
        with open(split_path, "rb") as f:
            return pickle.load(f)
    rng = np.random.RandomState(100)
    itv = 300 if case == "walk" else 90
    size = 100 if case == "walk" else 80
    ids = WALK_SPLIT if case == "walk" else RUN_SPLIT
    split = tuple(
        {i: rng.choice(np.arange(itv), size=size, replace=False)
         for i in ids[part]}
        for part in ("train", "val", "test"))
    try:
        with open(split_path, "wb") as f:
            pickle.dump(split, f)
    except OSError:
        pass
    return split


def build_edge_matrices(edges, n):
    """Skeleton + 2-hop adjacency (dataset.py:113-137) as dense matrices:
    (edge_attr [N, N, 1] with values {0, 1, 2}, edge_mask [N, N]), numpy
    float32."""
    adj = np.zeros((n, n), np.int32)
    for a, b in edges:
        adj[a, b] = adj[b, a] = 1
    adj2 = (adj @ adj) > 0
    attr = np.where(adj > 0, 1, np.where(adj2, 2, 0)).astype(np.float32)
    np.fill_diagonal(attr, 0)
    mask = (attr > 0).astype(np.float32)
    return attr[..., None], mask


@dataclasses.dataclass
class MotionDataset:
    """Single-target mocap dataset (the state at +delta_frame)."""

    data_dir: Path
    partition: str = "train"
    max_samples: int = 200
    delta_frame: int = 30
    case: str = "walk"
    device: str | torch.device = "cpu"

    def __post_init__(self):
        d = Path(self.data_dir)
        edges, x, v = _load_case(d, self.case)
        split = _load_split(d, self.case)
        mapping = split[{"train": 0, "val": 1, "test": 2}[self.partition]]
        each_len = self.max_samples // len(mapping)

        x0, v0, xt, vt = [], [], [], []
        for i in mapping:
            st = np.asarray(mapping[i][:each_len])
            x0.append(x[i][st])
            v0.append(v[i][st])
            xt.append(self._target(x[i], st))
            vt.append(self._target(v[i], st))
        dev = torch.device(self.device)
        on_device = lambda a: torch.from_numpy(  # noqa: E731
            np.asarray(a, np.float32)).to(dev)
        self.x_0 = on_device(np.concatenate(x0))
        self.v_0 = on_device(np.concatenate(v0))
        self.x_t = on_device(np.concatenate(xt))
        self.v_t = on_device(np.concatenate(vt))

        self.n_node = x[0].shape[1]
        attr, mask = build_edge_matrices(edges, self.n_node)
        self.edge_attr = on_device(attr)        # [N, N, 1] in {0, 1, 2}
        self.edge_mask = on_device(mask)        # [N, N]

    def _target(self, trial, st):
        """The target of start frames ``st``: the frame at +delta_frame
        (MotionDynamicsDataset: the T-frame decoder window)."""
        return trial[st + self.delta_frame]

    def __len__(self):
        return int(self.x_0.shape[0])

    def node_features(self, x0):
        """z-coordinate / 10 (dataset.py:156)."""
        return x0[..., 1:2] / 10.0


@dataclasses.dataclass
class MotionDynamicsDataset(MotionDataset):
    """Multi-frame targets for the EGNO decoder: frames
    delta_frame - T + 1 ... delta_frame (dataset.py:252-263, last=True)."""

    num_timesteps: int = 6

    def _target(self, trial, st):
        t = self.num_timesteps
        return np.stack([trial[st + self.delta_frame + ii - t]
                         for ii in range(1, t + 1)], axis=1)  # [S, T, N, 3]
