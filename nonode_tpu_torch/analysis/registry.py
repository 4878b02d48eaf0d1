"""The artifact / checkpoint file stem (the port's copy of
nonode_tpu/analysis/registry.py:artifact_stem)."""

from __future__ import annotations


def artifact_stem(model, dataset, seed, n_balls, num_inputs=1, dT=1,
                  varDT=False, num_timesteps=10):
    """Canonical artifact/checkpoint stem, as main.py writes it; append
    ``_results.npz`` for the trajectory artifact."""
    return (f"{model.upper()}_{dataset}_seed={seed}_n_part={n_balls}"
            f"_n_inputs={num_inputs}_dT_{dT}_varDT={varDT}"
            f"_num_timesteps={num_timesteps}")
