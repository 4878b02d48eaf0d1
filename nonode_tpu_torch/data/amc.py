"""CMU mocap ASF/AMC parsing and forward kinematics in NumPy: the port's
own copy of nonode_tpu/data/amc.py, with the same arithmetic (the two give
the same bits).

The skeleton is flattened to arrays once (preorder, parents before
children) and forward kinematics runs over all T frames of a trial at once:
batched 3x3 products per bone. ``trajectories_from_amc`` writes the
``(edges, [X_trial])`` layout of the motion pickles (EGNO/motion/
preprocess.py:12-37), and drops the first 6 frames of a trial whose AMC
stem ends in ``_10`` (preprocess.py:22-24).

ASF conventions (the CMU ASF/AMC spec): each bone has a direction vector, a
length, a rotation 'axis' (static-XYZ euler angles, degrees) defining the
local frame C, and a dof list naming which of rx/ry/rz appear per AMC
frame.
FK: M_bone = M_parent @ C @ R(motion) @ C^-1;
    x_bone = x_parent + length * M_bone @ direction.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def euler2mat(ai: float, aj: float, ak: float) -> np.ndarray:
    """Static-XYZ euler angles (radians) -> rotation matrix
    (transforms3d 'sxyz' convention: rotate about x by ai first, then y,
    then z, all in the static frame: M = Rz @ Ry @ Rx)."""
    return euler2mat_batch(np.stack([np.asarray(ai), np.asarray(aj),
                                     np.asarray(ak)], axis=-1))


def euler2mat_batch(angles: np.ndarray) -> np.ndarray:
    """Batched static-XYZ euler -> rotation matrices.

    angles: [..., 3] radians -> [..., 3, 3] with M = Rz @ Ry @ Rx.
    """
    a = np.asarray(angles, dtype=np.float64)
    si, sj, sk = np.sin(a[..., 0]), np.sin(a[..., 1]), np.sin(a[..., 2])
    ci, cj, ck = np.cos(a[..., 0]), np.cos(a[..., 1]), np.cos(a[..., 2])
    m = np.empty(a.shape[:-1] + (3, 3), dtype=np.float64)
    # Rz @ Ry @ Rx, written out
    m[..., 0, 0] = ck * cj
    m[..., 0, 1] = ck * sj * si - sk * ci
    m[..., 0, 2] = ck * sj * ci + sk * si
    m[..., 1, 0] = sk * cj
    m[..., 1, 1] = sk * sj * si + ck * ci
    m[..., 1, 2] = sk * sj * ci - ck * si
    m[..., 2, 0] = -sj
    m[..., 2, 1] = cj * si
    m[..., 2, 2] = cj * ci
    return m


@dataclasses.dataclass
class Bone:
    """One parsed ASF bone (or the root pseudo-bone)."""

    name: str
    direction: np.ndarray            # [3]
    length: float
    axis_deg: np.ndarray             # [3] static-XYZ euler, degrees
    dof: list
    limits: np.ndarray               # [3, 2] per rx/ry/rz channel
    parent: "Bone | None" = None
    children: list = dataclasses.field(default_factory=list)


class Skeleton:
    """Flat skeleton: preorder bone arrays + frame-vectorized FK."""

    def __init__(self, joints: dict[str, Bone]):
        root = joints["root"]
        order: list[Bone] = []

        def preorder(b: Bone):
            order.append(b)
            for c in b.children:
                preorder(c)

        preorder(root)
        self.names = [b.name for b in order]
        self.index = {n: i for i, n in enumerate(self.names)}
        n = len(order)
        self.parent = np.array(
            [-1 if b.parent is None else self.index[b.parent.name]
             for b in order])
        self.local = np.empty((n, 3, 3))        # C
        self.local_inv = np.empty((n, 3, 3))    # C^-1
        self.offset = np.empty((n, 3))          # length * direction
        # which rotation axes each bone reads from its AMC channel list,
        # in ascending axis order (a dof whose limits are exactly (0, 0) is
        # skipped — the reference's amc_parser has the same quirk)
        self.chan_axes = []
        for i, b in enumerate(order):
            self.local[i] = euler2mat_batch(np.deg2rad(b.axis_deg))
            self.local_inv[i] = np.linalg.inv(self.local[i])
            self.offset[i] = b.length * np.asarray(b.direction, float)
            self.chan_axes.append(
                np.nonzero((b.limits != 0).any(axis=1))[0])

    def edges(self) -> list[list[int]]:
        """[(child_idx, parent_idx)] over the preorder bone index."""
        return [[i, p] for i, p in enumerate(self.parent) if p >= 0]

    def channels(self, frames: list[dict]):
        """AMC frames -> (trans [T, 3], rot [T, N, 3] radians)."""
        t, n = len(frames), len(self.names)
        trans = np.zeros((t, 3))
        rot = np.zeros((t, n, 3))
        for ti, frame in enumerate(frames):
            root_vals = frame["root"]
            trans[ti] = root_vals[:3]
            rot[ti, 0] = root_vals[3:6]
            for name, vals in frame.items():
                if name == "root" or name not in self.index:
                    continue
                j = self.index[name]
                # consume values front-to-back, one per non-(0,0)-limit
                # axis, ignoring any extras — the reference's set_motion
                # walks limits and reads motion[name][idx] sequentially
                # (amc_parser.py:51-57), so surplus AMC channels are
                # silently dropped, never broadcast
                axes = self.chan_axes[j]
                rot[ti, j, axes] = vals[:len(axes)]
        return trans, np.deg2rad(rot)

    def fk(self, frames: list[dict]) -> np.ndarray:
        """Forward kinematics for a whole trial at once -> [T, N, 3]."""
        trans, rot = self.channels(frames)
        t, n = rot.shape[:2]
        local_rot = self.local[None] @ euler2mat_batch(rot) @ \
            self.local_inv[None]                       # [T, N, 3, 3]
        mats = np.empty((t, n, 3, 3))
        coords = np.empty((t, n, 3))
        mats[:, 0] = local_rot[:, 0]
        coords[:, 0] = trans
        for j in range(1, n):
            p = self.parent[j]
            mats[:, j] = mats[:, p] @ local_rot[:, j]
            coords[:, j] = coords[:, p] + \
                (mats[:, j] @ self.offset[j][:, None])[..., 0]
        return coords


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def parse_asf(path) -> dict[str, Bone]:
    """Parse an ASF skeleton file into a bone dict (root included)."""
    content = _lines(path)
    for idx, line in enumerate(content):
        if line.strip() == ":bonedata":
            content = content[idx + 1:]
            break

    def make(name, direction, length, axis, dof, limits):
        lm = np.zeros([3, 2])
        for pair, nm in zip(limits, dof):
            lm[{"rx": 0, "ry": 1, "rz": 2}[nm]] = pair
        return Bone(name, np.asarray(direction, float), length,
                    np.asarray(axis, float), list(dof), lm)

    joints = {"root": make("root", np.zeros(3), 0, np.zeros(3), [], [])}
    i = 0

    def tok():
        nonlocal i
        if i >= len(content):
            return None
        parts = content[i].strip().split()
        i += 1
        return parts

    line = tok()
    while line is not None and line and line[0] != ":hierarchy":
        assert line[0] == "begin", line
        fields = {}
        dof, limits = [], []
        line = tok()
        while line[0] != "end":
            if line[0] == "name":
                fields["name"] = line[1]
            elif line[0] == "direction":
                fields["direction"] = [float(v) for v in line[1:]]
            elif line[0] == "length":
                fields["length"] = float(line[1])
            elif line[0] == "axis":
                fields["axis"] = [float(v) for v in line[1:4]]
            elif line[0] == "dof":
                dof = line[1:]
                for _ in range(len(dof)):
                    line = tok()
                    vals = line[1:] if line[0] == "limits" else line
                    limits.append((float(vals[0].lstrip("(")),
                                   float(vals[1].rstrip(")"))))
            line = tok()
        joints[fields["name"]] = make(fields["name"], fields["direction"],
                                      fields["length"], fields["axis"],
                                      dof, limits)
        line = tok()

    # hierarchy
    assert line[0] == ":hierarchy"
    line = tok()
    assert line[0] == "begin"
    while True:
        line = tok()
        if line[0] == "end":
            break
        parent = line[0]
        for child in line[1:]:
            joints[parent].children.append(joints[child])
            joints[child].parent = joints[parent]
    return joints


def parse_amc(path) -> list[dict]:
    """Parse an AMC motion file -> list of {joint: [channel values]}."""
    content = _lines(path)
    for idx, line in enumerate(content):
        if line.strip() == ":DEGREES":
            content = content[idx + 1:]
            break
    frames = []
    cur = None
    for line in content:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0].replace("-", "").isnumeric():
            if cur is not None:
                frames.append(cur)
            cur = {}
        else:
            cur[parts[0]] = [float(v) for v in parts[1:]]
    if cur:
        frames.append(cur)
    return frames


def trajectories_from_amc(asf_path, amc_paths) -> tuple[list, list]:
    """Preprocess ASF+AMC files into (edges, [X_trial [T, N, 3]]) — the
    motion.pkl format (EGNO/motion/preprocess.py:12-37), including the
    special case that drops the first 6 frames of any trial whose AMC
    filename stem ends in ``_10`` (preprocess.py:22-24)."""
    skel = Skeleton(parse_asf(asf_path))
    trials = []
    for amc in amc_paths:
        motions = parse_amc(amc)
        if str(amc).split(".")[-2].split("_")[-1] == "10":
            motions = motions[6:]
        trials.append(skel.fk(motions))
    return skel.edges(), trials
