"""PyTorch + CUDA port of ``nonode_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``nonode_tpu``'s layout module for module. It imports
torch and numpy only, never JAX and nothing of ``nonode_tpu``: what it needs
from there it keeps as its own copy. Every kernel that ``nonode_tpu`` wrote in
Pallas for the TPU is a hand-written CUDA kernel here (``csrc/``), bound with
ctypes (``ops/kernels/``), with a plain PyTorch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line); without CUDA they raise.
"""
