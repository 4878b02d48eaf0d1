"""The work the benchmark's shares divide by: operations and bytes from a
call's shapes, never from what the program launches. ``PEAKS`` are one
NVIDIA H100 SXM's published dense rates (NVIDIA's data sheet, at the full
700 W): a share is against them, with the card's power limit printed
beside it. A model's useful products are in ``counts/<model>.py``, the
pairwise chain's operations and bytes in ``pairwise``."""

PEAKS = {
    "tf32_flops": 495e12,      # TF32 on the tensor cores
    "fp32_flops": 67e12,       # float32 on the CUDA cores
    "hbm_bytes": 3.35e12,      # HBM3 bytes a second
}
