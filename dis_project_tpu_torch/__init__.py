"""PyTorch/CUDA port of ``dis_project_tpu`` for the NVIDIA H100.

The JAX package stays the reference; this package imports ``torch`` and
numpy only, never ``jax`` and nothing of ``dis_project_tpu``. Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``. The
hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc``
at first use (``ops/cuda_build.py``).
"""
