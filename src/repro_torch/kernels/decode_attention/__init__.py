"""Flash-decoding attention: CUDA kernel, wrapper, plain version."""
