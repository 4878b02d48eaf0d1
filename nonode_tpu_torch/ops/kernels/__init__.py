"""Hand-written Hopper kernels of the port, one module each, with the TPU
kernel each replaces. ``KERNELS`` lists them for tools that build, count and
check every kernel (chip_smoke.py)."""

from . import egnn_fused, nbody_sim, pairwise

KERNELS = [
    {"name": "egnn_pairwise_fwd", "route": "cuda",
     "source": f"nonode_tpu_torch/csrc/{egnn_fused.SOURCE}",
     "replaces": "nonode_tpu/ops/pallas/egnn_fused.py:130",
     "csrc": egnn_fused.SOURCE, "wrapper": egnn_fused.pairwise_message},
    {"name": "egnn_pairwise_bwd", "route": "cuda",
     "source": f"nonode_tpu_torch/csrc/{egnn_fused.BWD_SOURCE}",
     "replaces": "nonode_tpu/ops/pallas/egnn_fused.py:147",
     "csrc": egnn_fused.BWD_SOURCE,
     "wrapper": egnn_fused.pairwise_message_bwd},
    {"name": "nbody_charged_force", "route": "cuda",
     "source": f"nonode_tpu_torch/csrc/{pairwise.SOURCE}",
     "replaces": "nonode_tpu/ops/pallas/pairwise.py:95",
     "csrc": pairwise.SOURCE, "wrapper": pairwise.charged_force},
    {"name": "nbody_gravity_accel", "route": "cuda",
     "source": f"nonode_tpu_torch/csrc/{pairwise.SOURCE}",
     "replaces": "nonode_tpu/ops/pallas/pairwise.py:37",
     "csrc": pairwise.SOURCE, "wrapper": pairwise.gravity_accel},
    {"name": "nbody_charged_leapfrog", "route": "cuda",
     "source": f"nonode_tpu_torch/csrc/{nbody_sim.SOURCE}",
     "replaces": "nonode_tpu/ops/pallas/nbody_sim.py:134",
     "csrc": nbody_sim.SOURCE, "wrapper": nbody_sim.charged_leapfrog},
    {"name": "nbody_gravity_leapfrog", "route": "cuda",
     "source": f"nonode_tpu_torch/csrc/{nbody_sim.SOURCE}",
     "replaces": "nonode_tpu/ops/pallas/nbody_sim.py:77",
     "csrc": nbody_sim.SOURCE, "wrapper": nbody_sim.gravity_leapfrog},
]
