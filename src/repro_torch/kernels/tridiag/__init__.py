"""Batched tridiagonal (Thomas) solve: CUDA kernel, wrapper, plain version."""
