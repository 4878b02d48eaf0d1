"""Energy and correlation metrics on device tensors (counterpart of
nonode_tpu/train/metrics.py:65-138).

- tot_energy_charged_batch: K = 0.5 sum |v|^2, U = 0.5 k sum_{i != j}
  q_i q_j / r_ij (both orders counted).
- tot_energy_gravity_batch: KE = 0.5 sum m |v|^2, PE = G sum_{i<j}
  -(m_i m_j) / r_ij.
- conserved_energy: dispatch on the dataset name.
- energy_drift: |Et - E0| / (E0 + 1e-10).
- pearson_correlation_batch: per-sample correlation over the flattened
  (N*3) state on the first 40% of the horizon.
"""

from __future__ import annotations

import torch


def tot_energy_charged_batch(loc, vel, edges, interaction_strength=1.0):
    """loc, vel: [..., N, 3]; edges: [..., N, N] interaction products."""
    k = 0.5 * (vel ** 2).sum(dim=(-1, -2))
    diff = loc[..., :, None, :] - loc[..., None, :, :]
    dist = torch.sqrt((diff ** 2).sum(-1))
    dist = torch.where(dist == 0, torch.full_like(dist, float("inf")), dist)
    u = 0.5 * interaction_strength * (edges / dist).sum(dim=(-1, -2))
    return k + u


def tot_energy_gravity_batch(loc, vel, mass, G=1.0):
    """loc, vel: [..., N, 3]; mass: [..., N, 1]."""
    ke = 0.5 * (mass * vel ** 2).sum(dim=(-1, -2))
    diff = loc[..., :, None, :] - loc[..., None, :, :]
    r = torch.sqrt((diff ** 2).sum(-1))
    inf = torch.full_like(r, float("inf"))
    inv_r = torch.where(r > 0, 1.0 / torch.where(r == 0, inf, r),
                        torch.zeros_like(r))
    mm = mass[..., :, None, 0] * mass[..., None, :, 0]
    n = loc.shape[-2]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=loc.device), 1)
    pe = G * torch.where(upper, -mm * inv_r, torch.zeros_like(inv_r)).sum(
        dim=(-1, -2))
    return ke + pe


def conserved_energy(dataset: str, loc, vel, charges):
    """loc, vel: [..., B, N, 3]; charges: [B, N, 1] (charges for 'charged',
    masses for 'gravity')."""
    if dataset == "gravity":
        return tot_energy_gravity_batch(loc, vel, charges)
    if dataset == "charged":
        w = torch.einsum("...ik,...jk->...ij", charges, charges)
        return tot_energy_charged_batch(loc, vel, w)
    raise ValueError(f"Unknown dataset: {dataset}")


def energy_drift(energies):
    """energies: [T, ...] -> |Et - E0| / (E0 + 1e-10), shape [T, ...]."""
    e0 = energies[0]
    return torch.abs((energies - e0) / (e0 + 1e-10))


def pearson_correlation_batch(x, y, n_nodes: int):
    """x, y: [T, B*N, 3] predictions / ground truth.

    Returns (correlation [B, cut], avg_num_steps scalar, first_failure_index
    scalar) with cut = max(int(0.4 * T), 1).
    """
    t = x.shape[0]
    cut = max(int(0.4 * t), 1)  # the reference's int(0.4*T) breaks for T < 3
    b = x.shape[1] // n_nodes
    xs = x.reshape(t, b, -1)[:cut].transpose(0, 1)       # [B, cut, N*3]
    ys = y.reshape(t, b, -1)[:cut].transpose(0, 1)

    xm = xs - xs.mean(dim=2, keepdim=True)
    ym = ys - ys.mean(dim=2, keepdim=True)
    cov = (xm * ym).sum(dim=2)
    std_x = torch.sqrt((xm ** 2).sum(dim=2))
    std_y = torch.sqrt((ym ** 2).sum(dim=2))
    corr = cov / (std_x * std_y)                         # [B, cut]

    below = corr < 0.5
    any_below = below.any(dim=1)
    first_below = torch.argmax(below.to(torch.int32), dim=1)
    num_steps = torch.where(any_below, first_below,
                            torch.full_like(first_below, cut))
    avg_num_steps = num_steps.to(torch.float32).mean()

    col_ok = (corr >= 0.5).all(dim=0)                    # [cut]
    first_failure = (torch.tensor(corr.shape[1], device=corr.device)
                     if bool(col_ok.all())
                     else torch.argmax((~col_ok).to(torch.int32)))
    return corr, avg_num_steps, first_failure
