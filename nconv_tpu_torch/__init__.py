"""PyTorch/CUDA port of nconv_tpu: two-stage normalized-convolution depth
completion with hand-written Hopper kernels.

Imports torch and numpy only. Entry points run on CUDA unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version. The JAX package ``nconv_tpu`` is the reference the port is
held against (``tests/test_torch_*.py``).
"""
