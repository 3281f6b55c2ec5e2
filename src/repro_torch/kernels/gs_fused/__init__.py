"""The fused Gauss-Seidel sweep loop: CUDA kernel, wrapper, plain version."""
