"""Hand-written Hopper kernels of the port, one module each, with the TPU
kernel each replaces. ``KERNELS`` lists them for tools that build, count and
check every kernel (chip_smoke.py)."""

from . import egnn_fused

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
]
