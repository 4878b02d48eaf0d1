"""Results analysis (the port's copy of nonode_tpu/analysis/results.py):
the aggregation layer behind the reference's plotting.py / test.ipynb
figures and tables, over the drivers' ``.npz`` artifacts.

These functions run on the host in numpy, as in the JAX package: they read
finished artifacts and do no device work, and the same float64 operations
give the JAX package's answers bit for bit. matplotlib is imported only by
``plot_multiple_curves``.

Semantics mirrored (definitions, not code):
- per-timestep MSE/MAE over samples+dims, mean ± std across seeds
  (plotting.py:400-429 compute_mse_mean_std_per_timestep);
- per-timestep correlation over the flattened (samples, N*3) state
  (plotting.py:552-612 compute_correlation[_per_timestep]);
- energy-drift curves (plotting.py:961+ compute_energy_mean_std_per_timestep:
  mean of squared drift over samples per timestep);
- horizon-averaged loss until correlation drops below a threshold
  (plotting.py:871-935 compute_avg_loss_until_t);
- LaTeX summary tables (plotting.py:859 print_latex_table).
"""

from __future__ import annotations

import numpy as np
import torch

from ..compat.ref_stubs import install


def load_artifact(path):
    """Load a trajectory artifact -> dict of arrays
    (targets [B, T, N, 3], preds [B, Tc, N, 3], energy_conservation
    [B, Tc, 1], test_loss scalar).

    Accepts both the drivers' ``.npz`` artifacts and the reference's
    ``*_results.pt`` torch pickles (main.py:188-191), so reference and
    rebuild curves land on one plot."""
    if str(path).endswith((".pt", ".pth", ".pkl")):
        return load_reference_results(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_reference_results(path):
    """Load a reference trajectory artifact (torch pickle of a
    torch_geometric ``Data`` holding targets/preds/energy_conservation/
    test_loss, main.py:190). Works without torch_geometric installed: the
    compat stubs provide a picklable Data class, and real-PyG pickles are
    absorbed by scanning the object graph for the artifact keys."""
    install()
    obj = torch.load(path, map_location="cpu", weights_only=False)

    def to_np(v):
        if torch.is_tensor(v):
            return v.detach().cpu().numpy()
        return v

    # stub Data / plain dict / namespace-ish / real PyG (BaseStorage keeps
    # its keys in _store._mapping, not _store.__dict__)
    store = getattr(obj, "_store", None)
    for d in (obj if isinstance(obj, dict) else None,
              getattr(obj, "__dict__", None),
              getattr(store, "__dict__", None),
              getattr(store, "_mapping", None)):
        if d and "targets" in d and "preds" in d:
            out = {"targets": to_np(d["targets"]), "preds": to_np(d["preds"])}
            # EGNO run_epoch emits 'energy_conservation' + 'test_loss'
            # (main_simulation_simple_no.py:303); SEGNO emits 'energies' and
            # merges its res dict, so the scalar is loss/counter
            # (train_nbody.py:191-195)
            e = d.get("energy_conservation", d.get("energies"))
            if e is not None:
                out["energy_conservation"] = to_np(e)
            if "test_loss" in d:
                out["test_loss"] = to_np(d["test_loss"])
            elif "loss" in d and d.get("counter"):
                out["test_loss"] = float(d["loss"]) / float(d["counter"])
            return out
    raise ValueError(f"unrecognized reference artifact layout in {path}")


def _flat(t):
    """[B, T, N, 3] -> [B, T, N*3] in float64 (diverged rollout samples
    overflow float32 squares)."""
    b, tt = t.shape[0], t.shape[1]
    return t.reshape(b, tt, -1).astype(np.float64)


def mse_per_timestep(targets, preds):
    """Mean squared error per timestep, averaged over samples and dims."""
    tc = min(targets.shape[1], preds.shape[1])
    d = _flat(targets)[:, :tc] - _flat(preds)[:, :tc]
    return (d ** 2).mean(axis=(0, 2))


def mae_per_timestep(targets, preds):
    tc = min(targets.shape[1], preds.shape[1])
    d = _flat(targets)[:, :tc] - _flat(preds)[:, :tc]
    return np.abs(d).mean(axis=(0, 2))


def correlation_per_timestep(targets, preds):
    """Pearson correlation per timestep over the flattened (B, N*3) state."""
    tc = min(targets.shape[1], preds.shape[1])
    a = _flat(targets)[:, :tc].transpose(1, 0, 2).reshape(tc, -1)
    b = _flat(preds)[:, :tc].transpose(1, 0, 2).reshape(tc, -1)
    ca = a - a.mean(axis=1, keepdims=True)
    cb = b - b.mean(axis=1, keepdims=True)
    cov = (ca * cb).sum(axis=1)
    return cov / (np.sqrt((ca ** 2).sum(1)) * np.sqrt((cb ** 2).sum(1)))


def energy_drift_per_timestep(energy):
    """energy: [B, T, 1] per-step conserved energy -> mean over samples of
    the squared relative drift |Et - E0| / (E0 + 1e-10), per timestep."""
    energy = energy.astype(np.float64)
    e0 = energy[:, :1]
    with np.errstate(over="ignore", invalid="ignore"):
        drift = np.abs((energy - e0) / (e0 + 1e-10))
        return (drift[..., 0] ** 2).mean(axis=0)


def short_horizon_loss(artifact, h_frames=20, frames_per_entry=1,
                       bound_mult=10.0):
    """Headline loss at a PHYSICAL horizon of `h_frames` sampled frames,
    comparable ACROSS models whose artifacts log on different grids: EGNO
    artifacts store one entry per frame (train/loop.py
    EGNOExperiment.test_rollout) while SEGNO artifacts store one entry per
    `num_timesteps`-frame window (pred_indices = start +
    cumsum([T]*traj_len), SEGNOExperiment.test_rollout) — both layouts
    match the reference's own artifacts
    (main_simulation_simple_no.py:342-384 / SEGNO/train_nbody.py:118-140).
    Entry i sits at frame (i+1)*frames_per_entry, so the horizon covers the
    entries with (i+1)*frames_per_entry <= h_frames, and the loss is the MSE
    over each artifact's native logging grid within those frames (exactly
    how the reference's own 40%-cut `test_loss` averages each model's
    native grid; main_simulation_simple_no.py:239-244). Default 20 frames =
    2 SEGNO windows at the canonical T=10 and the reference's 40% cut at
    traj_len 5 for EGNO. At the grids' traj_len 20 the 200-frame
    `test_loss` is dominated by diverged-sample noise for EGNO (finite
    fractions <= 0.3, RESULTS.md); this gives every cell a comparable
    headline number from the stored artifact.

    `bound_mult` scales the "converged" range (default 10x the ground-truth
    coordinate range, the heuristic of train/loop.py _finite_metrics;
    scripts/bound_sensitivity.py sweeps it 3x/10x/30x to show the
    published finite fractions are not knife-edge on it).

    Returns (loss_all_samples, loss_finite_samples, finite_frac@h)."""
    preds = np.asarray(artifact["preds"])
    targets = np.asarray(artifact["targets"])[:, : preds.shape[1]]
    k = min(max(h_frames // frames_per_entry, 1), preds.shape[1])
    p = _flat(preds)[:, :k]
    t = _flat(targets)[:, :k]
    with np.errstate(invalid="ignore", over="ignore"):
        loss = float(np.mean((p - t) ** 2))
        bound = bound_mult * max(float(np.abs(t).max()), 1.0)
        ok = (np.isfinite(p) & (np.abs(p) <= bound)).all(axis=(1, 2))
        loss_f = float(np.mean((p[ok] - t[ok]) ** 2)) if ok.any() \
            else float("nan")
    return loss, loss_f, float(ok.mean())


def mean_std_over_seeds(per_seed_curves):
    """[n_seeds, T] -> (mean [T], std [T]); std uses ddof=1 like torch.std."""
    c = np.stack(per_seed_curves)
    std = c.std(axis=0, ddof=1) if c.shape[0] > 1 else np.zeros(c.shape[1])
    return c.mean(axis=0), std


def avg_loss_until_corr(mean_losses, mean_corr, threshold=0.99):
    """Average loss over the horizon until mean correlation drops below the
    threshold; returns (index, avg_loss).

    When correlation never drops, the reference slices with index=-1 BEFORE
    resetting it to the horizon length (plotting.py:902-911), so the
    average excludes the LAST timestep while the returned index is the full
    horizon — replicated here."""
    below = np.where(mean_corr < threshold)[0]
    if len(below):
        index = int(below[0])
        avg = float(np.mean(mean_losses[:index])) if index > 0 \
            else float("nan")
    else:
        index = len(mean_losses)
        avg = float(np.mean(mean_losses[:-1])) if index > 1 else float("nan")
    return index, avg


def analyze_group(artifact_paths):
    """Aggregate a seed-group of artifacts into mean ± std curves."""
    mses, maes, corrs, drifts, test_losses = [], [], [], [], []
    for p in artifact_paths:
        a = load_artifact(p)
        mses.append(mse_per_timestep(a["targets"], a["preds"]))
        maes.append(mae_per_timestep(a["targets"], a["preds"]))
        corrs.append(correlation_per_timestep(a["targets"], a["preds"]))
        # motion artifacts carry no energy: the reference stores
        # energy_conservation=None when the dataset has no energy_fun
        # (main_simulation_simple_no.py:380) — mirror that as a missing key
        if "energy_conservation" in a:
            drifts.append(energy_drift_per_timestep(a["energy_conservation"]))
        test_losses.append(float(a["test_loss"]))
    out = {}
    for name, curves in [("mse", mses), ("mae", maes), ("corr", corrs),
                         ("energy_drift", drifts)]:
        if not curves:        # energy-free artifacts (motion)
            continue
        mean, std = mean_std_over_seeds(curves)
        out[f"{name}_mean"], out[f"{name}_std"] = mean, std
    out["test_loss_mean"] = float(np.mean(test_losses))
    out["test_loss_std"] = float(np.std(test_losses, ddof=1)) \
        if len(test_losses) > 1 else 0.0
    out["n_seeds"] = len(artifact_paths)
    return out


def latex_table(rows, caption="Results", label="tab:results"):
    """rows: list of (name, mean, std) -> LaTeX tabular (the
    print_latex_table output shape, plotting.py:859)."""
    lines = [r"\begin{table}[h]", r"\centering",
             r"\begin{tabular}{lc}", r"\toprule",
             r"Configuration & test loss \\", r"\midrule"]
    for name, mean, std in rows:
        lines.append(rf"{name} & ${mean:.4f} \pm {std:.4f}$ \\")
    lines += [r"\bottomrule", r"\end{tabular}",
              rf"\caption{{{caption}}}", rf"\label{{{label}}}",
              r"\end{table}"]
    return "\n".join(lines)


def plot_multiple_curves(curves, out_path=None, ylabel="MSE", logy=True,
                         title=None):
    """Multi-curve figure with ± std bands (plot_multiple_curves,
    plotting.py:981+). curves: {label: (mean [T], std [T])}."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, (mean, std) in curves.items():
        x = np.arange(1, len(mean) + 1)
        ax.plot(x, mean, label=label)
        ax.fill_between(x, mean - std, mean + std, alpha=0.2)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("timestep")
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
        return out_path
    return fig
