from .egno import EGNO
from .segno import SEGNO
from .baselines import (GNN, EGMN, EquivariantScalarNet, FullMLP,
                        LinearDynamics, RFVel)
