"""Sweep-ledger + artifact join (the port's copy of
nonode_tpu/analysis/ledger.py), the load pipeline of the RESULTS.md table
tools: parse every ``sweep_*.jsonl`` ledger in an outf directory
(parallel/sweep.py's resume format), look up each record's trajectory
artifact by the canonical filename stem (registry.artifact_stem), and attach
the divergence-aware companion metrics (finite_fraction / test_loss_finite
from the artifact, loss@20-frames via results.short_horizon_loss). Host-side
numpy, as results.py.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from .registry import artifact_stem
from .results import short_horizon_loss


def iter_ledger_artifacts(outf):
    """Yield (record, config, artifact_path_or_None) for every row of every
    ``sweep_*.jsonl`` ledger under outf, resolving each row's trajectory
    artifact by the canonical stem (None when the file is missing).
    Deduplicates by config_id across ledgers — a resumable sweep ledger may
    INHERIT rows from a sibling ledger in the same directory (e.g.
    pro_ref/sweep_PRO.jsonl inherits the PRO_HEADLINE cells), and a
    double-counted seed would silently skew every group statistic."""
    outf = Path(outf)
    recs, seen = [], set()
    for ledger in sorted(outf.glob("sweep_*.jsonl")):
        for line in ledger.read_text().splitlines():
            rec = json.loads(line)
            cid = rec.get("config_id")
            if cid in seen:
                continue
            seen.add(cid)
            recs.append(rec)
    for r in recs:
        c = r["config"]
        # forward any non-default windowing the grid swept: the stem must
        # match the file the driver wrote, and the SEGNO window stride is
        # num_timesteps (a stale default here means silent-NaN companions
        # or a wrong physical horizon)
        num_timesteps = int(c.get("num_timesteps", 10))
        stem = artifact_stem(c["model"], c["dataset"], c["seed"],
                             c["n_balls"], c["num_inputs"],
                             dT=int(c.get("dT", 1)), varDT=c["varDT"],
                             num_timesteps=num_timesteps)
        art = outf / c.get("exp_name", "_exp_new") / (stem + "_results.npz")
        yield r, c, (art if art.exists() else None)


def load_companions(outf) -> tuple[dict, dict]:
    """Committed companion snapshot (scripts/companion_snapshot.py):
    ({config_id: seed-row}, {group-key-tuple: group-row}). The artifacts the
    companion columns derive from are gitignored and machine resets have
    wiped them (round 4: 18 cells; round 5: the whole tree), so the snapshot
    is the durable record — seed rows are recomputed whenever an artifact is
    live, group rows transcribe previously-published aggregates for cells
    wiped before any per-seed snapshot existed."""
    path = Path(outf) / "companions.jsonl"
    seed_rows, group_rows = {}, {}
    if path.exists():
        for line in path.read_text().splitlines():
            r = json.loads(line)
            if r.get("kind") == "group":
                group_rows[tuple(r["key"])] = r
            else:
                seed_rows[r["config_id"]] = r
    return seed_rows, group_rows


def load_ledger_groups(outf) -> dict:
    """{(model, dataset, n_balls, num_inputs, varDT): [per-seed records]}.

    Each record: {val, test, best_epoch, ff, tlf, h20, ff20} — ledger
    best-val/test plus artifact companions (NaN when the artifact is
    missing). h20/ff20 are at a 20-FRAME physical horizon for both models
    (EGNO logs per frame, SEGNO per num_timesteps-frame window — see
    results.short_horizon_loss), so the column is cross-model comparable.
    When the artifact is gone (reset-wiped), the committed per-seed
    companion snapshot supplies the same four values.
    """
    groups = defaultdict(list)
    snap, _ = load_companions(outf)
    for r, c, art in iter_ledger_artifacts(outf):
        num_timesteps = int(c.get("num_timesteps", 10))
        ff = tlf = h20 = ff20 = float("nan")
        if art is None and r["config_id"] in snap:
            s = snap[r["config_id"]]
            ff, tlf = s["ff"], s["tlf"]
            h20, ff20 = s["h20"], s["ff20"]
        if art is not None:
            d = np.load(art, allow_pickle=True)
            if "finite_fraction" in d.files:
                ff = float(d["finite_fraction"])
            if "test_loss_finite" in d.files:
                tlf = float(d["test_loss_finite"])
            # EGNO artifacts log one entry per FRAME, SEGNO one entry per
            # num_timesteps-frame WINDOW (encoded in the artifact stem) —
            # a frame-based horizon needs the stride
            fpe = 1 if c["model"] == "egno" else num_timesteps
            h20, _, ff20 = short_horizon_loss(d, frames_per_entry=fpe)
        key = (c["model"], c["dataset"], c["n_balls"], c["num_inputs"],
               bool(c["varDT"]))
        groups[key].append({"val": r["best_val_loss"], "test": r["test_loss"],
                            "best_epoch": r.get("best_epoch", -1),
                            "ff": ff, "tlf": tlf, "h20": h20, "ff20": ff20})
    return groups


def mean_std(vals) -> str:
    """'mean ± std' with ddof=1, the reference's seed-aggregation formula."""
    vals = np.asarray(vals, dtype=float)
    std = np.std(vals, ddof=1) if len(vals) > 1 else 0.0
    return f"{np.mean(vals):.4f} ± {std:.4f}"
