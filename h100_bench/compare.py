"""The arithmetic of the comparisons that decide ``correct``. Each number
is a gap between what the program produced and what the plain reference
computes from the same inputs and weights; a gap that is not a finite
number counts as infinite.

Two constants of the comparison, the same for every cell:

- ``FLOOR``: the least float32 reference gap a number is measured in
  units of (a reference that lands on float64 exactly reads 0);
- ``BOUND_MULT``: a rollout's sample is compared while its float64
  reference stays finite and within this many times the data's range;
- ``FORCED_MULT``: a window held to the reference from the program's own
  state is compared where the float64 answer stays within this many
  times the data's range: far inside float32's, so that no float32
  computation of it overflows (the squares of positions of 1e7 are
  1e14; float32 ends at 3e38)."""

from __future__ import annotations

import math

import numpy as np
import torch

FLOOR = 1e-6
BOUND_MULT = 10.0
FORCED_MULT = 1e6


def references(mix, cap):
    """The reference's runs a mix's ``gaps`` holds the program to, from
    the inputs and weights in ``cap``: float32 (``want``) and float64
    (``exact``)."""
    return dict(want=mix.reference_run(cap),
                exact=mix.reference_run(cap, dtype=torch.float64))


def finite_or_inf(x) -> float:
    x = float(x)
    return x if math.isfinite(x) else math.inf


def rel_gaps(got, want):
    """|got - want| / |want| elementwise: 0 where both are not finite (the
    model's own behaviour), infinite where one of them is not or the
    shapes differ."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return np.full(want.shape, np.inf)
    gf, wf = np.isfinite(got), np.isfinite(want)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(got - want) / np.abs(want)
    gap = np.where(got == want, 0.0, gap)
    return np.where(gf & wf, gap, np.where(gf | wf, np.inf, 0.0))


def norm_gaps(got, want, names):
    """[leaf] the gap between the norms of matching leaves, each measured
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (infinite for a leaf missing or not finite).
    ``got``, ``want``: {name: array}; ``names``: the leaves compared."""
    g = np.array([np.linalg.norm(np.asarray(got[n], np.float64))
                  if n in got else np.inf for n in names])
    w = np.array([np.linalg.norm(np.asarray(want[n], np.float64))
                  for n in names])
    gap = np.abs(g - w) / np.maximum(w, np.median(w))
    return np.where(np.isfinite(gap), gap, np.inf)


def in_units(gaps, units):
    """The worst of ``gaps`` in units of the worst of ``units`` (the
    float32 reference's own gaps over the same numbers), at least
    ``FLOOR``."""
    gaps = np.asarray(gaps, np.float64)
    if gaps.size == 0:
        return 0.0
    return finite_or_inf(gaps.max() / max(float(np.max(units)), FLOOR))


def exact_gap(got, want):
    """The largest |got - want|: 0 where every value is the same (NaN
    where both are NaN), infinite where the shapes differ or only one
    side is not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return math.inf
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    if same.all():
        return 0.0
    with np.errstate(invalid="ignore"):
        return finite_or_inf(np.abs(got - want)[~same].max())


def sample_gaps(got, want):
    """[M] gaps of M matching samples (got, want [M, ...]): the norm of
    the difference over the larger of the reference's norm and the median
    sample's; infinite where the program's values are not finite."""
    if not len(want):
        return np.zeros(0)
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    if got.shape != want.shape:
        return np.full(len(want), np.inf)
    with np.errstate(invalid="ignore", over="ignore"):
        dn = np.sqrt(((got - want) ** 2).sum(-1))
        rn = np.sqrt((want ** 2).sum(-1))
        gap = dn / np.maximum(rn, np.median(rn))
    return np.where(np.isfinite(gap), gap, np.inf)


def _windows(a, frames):
    """[S, W, values]: the frames of each sample grouped into windows of
    ``frames`` (the last one may be shorter, and is padded with zeros)."""
    a = np.asarray(a, np.float64)
    s, f = a.shape[:2]
    w = -(-f // frames)
    pad = np.zeros((s, w * frames - f) + a.shape[2:])
    return np.concatenate([a, pad], axis=1).reshape(s, w, -1)


def window_gaps(got, want, region, frames):
    """[S, W] gaps of a rollout's windows: for each sample and window
    inside ``region`` ([S] windows each sample keeps), the norm of the
    difference over the window's ``frames`` frames against the reference's
    norm there or the median sample's at that window, whichever is
    larger; NaN outside the region, infinite where the program's values
    are not finite inside it. got, want: [S, frames kept, ...]; None when
    their shapes differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return None
    with np.errstate(invalid="ignore", over="ignore"):
        d = _windows(got, frames) - _windows(want, frames)
        dn = np.sqrt((d * d).sum(-1))
        ref = _windows(want, frames)
        rn = np.sqrt((ref * ref).sum(-1))
    w = dn.shape[1]
    inside = np.arange(w)[None, :] < np.asarray(region)[:, None]
    med = np.array([np.median(rn[inside[:, j], j]) if inside[:, j].any()
                    else 0.0 for j in range(w)])
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = dn / np.maximum(rn, med[None, :])
    gap = np.where(np.isfinite(gap), gap, np.inf)
    return np.where(inside, gap, np.nan)


def worst(gaps):
    """The largest of ``window_gaps``' gaps (None, shapes that differ:
    infinite)."""
    if gaps is None:
        return math.inf
    if np.isnan(gaps).all():
        return 0.0
    return finite_or_inf(np.nanmax(gaps))


def bounded_windows(pred, truth, frames):
    """[S] the windows each sample's reference rollout keeps before it
    leaves the bounded region: its first window with a value not finite
    or beyond ``BOUND_MULT`` times the data's range (``truth``, at least
    1) ends it."""
    bound = data_bound(truth, BOUND_MULT)
    with np.errstate(invalid="ignore"):
        bad = ~(np.isfinite(pred) & (np.abs(pred) <= bound))
    bad = _windows(bad, frames).any(-1)
    return np.where(bad.any(1), bad.argmax(1), bad.shape[1])


def data_bound(truth, mult):
    """``mult`` times the data's range: the largest |value| of ``truth``,
    at least 1."""
    return mult * max(float(np.abs(truth).max()), 1.0)
