"""PyTorch/CUDA port of ``lvc_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout. It imports
torch and numpy, never jax and nothing of ``lvc_tpu``. Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
