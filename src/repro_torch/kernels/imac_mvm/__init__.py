"""Quantised differential analog MVM: CUDA kernel, wrapper, plain version."""
