from .results import (
    load_artifact,
    mse_per_timestep,
    mae_per_timestep,
    correlation_per_timestep,
    mean_std_over_seeds,
    energy_drift_per_timestep,
    avg_loss_until_corr,
    latex_table,
)
