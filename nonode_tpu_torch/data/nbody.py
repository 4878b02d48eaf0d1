"""N-body dataset, resident on the chosen device (counterpart of
nonode_tpu/data/nbody.py:35-157).

Reads the reference's ``.npy`` layout
(``{loc,vel,charges}_{train,valid,test}_{dataset}{n}_initvel1{suffix}.npy``)
with its quirks: charged files store loc/vel as [S, T, 3, N] and are
transposed on load; gravity files keep masses in the ``charges`` slot. The
whole split lives on the device, a batch is an index gather, and pair
weights are the dense ``q q^T`` [S, N, N, 1] tensor.

Windows follow NBodyDynamicsDataset.__getitem__: frame_0 = 30 (charged
nbody_small) / 0 (gravity); output frames
``arange(frame_0+1, frame_0 + T*traj_len*dT + 1, dT)`` truncated at the
trajectory end.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..runtime import resolve_device

FRAME0 = {"charged": {"nbody": 6, "nbody_small": 30, "nbody_small_out_dist": 20},
          "gravity": {"nbody": 0, "nbody_small": 0, "nbody_small_out_dist": 0}}


def random_ascending(rng: np.random.RandomState, length, min_value, max_value):
    """Unique ascending random ints in [min_value, max_value]."""
    vals = rng.permutation(max_value - min_value + 1)[:length] + min_value
    return np.sort(vals)


@dataclasses.dataclass
class NBodyDataset:
    data_dir: Path
    partition: str = "train"          # train | val | test
    dataset: str = "charged"          # charged | gravity
    dataset_name: str = "nbody_small"
    n_balls: int = 5
    max_samples: int = int(1e8)
    num_timesteps: int = 10
    num_inputs: int = 1
    traj_len: int = 1
    dT: int = 1
    varDT: bool = False
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        suffix = "valid" if self.partition == "val" else self.partition
        if self.dataset_name == "nbody":
            suffix += f"_{self.dataset}{self.n_balls}_initvel1"
        elif self.dataset_name in ("nbody_small", "nbody_small_out_dist"):
            suffix += f"_{self.dataset}{self.n_balls}_initvel1small"
        else:
            raise ValueError(f"Wrong dataset name {self.dataset_name}")
        self.suffix = suffix

        d = Path(self.data_dir)
        loc = np.load(d / f"loc_{suffix}.npy").astype(np.float32)
        vel = np.load(d / f"vel_{suffix}.npy").astype(np.float32)
        charges = np.load(d / f"charges_{suffix}.npy").astype(np.float32)
        if loc.shape[-2:] != (self.n_balls, 3):
            loc = np.transpose(loc, (0, 1, 3, 2))
            vel = np.transpose(vel, (0, 1, 3, 2))
            if loc.shape[-2:] != (self.n_balls, 3):
                raise ValueError(f"Shape mismatch: loc {loc.shape} for "
                                 f"n_balls={self.n_balls}")
        if self.dataset == "gravity" and not (charges > 0).all():
            raise ValueError(
                "Charges (i.e. masses) in gravity dataset should be positive")

        s = min(self.max_samples, loc.shape[0])
        loc, vel, charges = loc[:s], vel[:s], charges[:s]
        if charges.ndim == 2:
            charges = charges[..., None]

        self.start = FRAME0[self.dataset][self.dataset_name]
        self.n_frames = loc.shape[1]
        if self.start + 1 >= self.n_frames:
            raise ValueError(
                f"dataset has no frames after the window start: "
                f"{self.n_frames} saved frames but {self.dataset}/"
                f"{self.dataset_name} windows start at frame {self.start}")
        dev = self.device
        self.loc = torch.from_numpy(np.ascontiguousarray(loc)).to(dev)   # [S,F,N,3]
        self.vel = torch.from_numpy(np.ascontiguousarray(vel)).to(dev)
        self.charges = torch.from_numpy(charges).to(dev)                 # [S,N,1]
        # dense pair weights w_ij = q_i * q_j
        self.edge_weights = torch.from_numpy(
            np.einsum("sik,sjk->sij", charges, charges)[..., None]).to(dev)

    def __len__(self):
        return int(self.loc.shape[0])

    def out_indices(self, frame_0=None):
        """Output frame indices: arange(f0+1, f0 + T*traj_len*dT + 1, dT),
        truncated at the trajectory end."""
        f0 = self.start if frame_0 is None else frame_0
        frame_t = self.start + self.num_timesteps * self.traj_len * self.dT
        idx = np.arange(f0 + 1, frame_t + 1, self.dT)
        return idx[idx < self.n_frames]

    def sample_input_offsets(self, rng: np.random.RandomState):
        """Per-sample input frames for num_inputs > 1.

        Returns (frames [S, L] absolute, ascending; timesteps_in [S, L]
        relative to each sample's last input). varDT draws random ascending
        offsets per sample; otherwise they are equispaced by dT.
        """
        s, L, T = len(self), self.num_inputs, self.num_timesteps
        if not self.varDT:
            base = (np.arange(T) * self.dT)[:L]
            t_in = np.broadcast_to(-base[::-1], (s, L)).copy()
        else:
            t_in = np.stack([
                np.concatenate([[0], random_ascending(rng, L - 1, 1, T - 1)])
                for _ in range(s)])
            t_in = -t_in[:, ::-1]
        # the reference multiplies by dT a second time here
        # (dataset_simple.py:146), replicated
        frames = self.start + t_in * self.dT
        # push windows that start before frame 0 forward
        shift = np.maximum(-frames.min(axis=1, keepdims=True), 0)
        frames = frames + shift
        # per-sample relative timesteps; EGNOExperiment._batch applies the
        # reference's batch-global correction
        t_in_rel = (frames - frames[:, -1:]).astype(np.float32)
        return frames, t_in_rel
