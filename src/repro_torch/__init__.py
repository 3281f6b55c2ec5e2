"""IMAC-Sim on PyTorch and CUDA: the testIMAC circuit-solve path.

A port of the `repro` package (JAX) to PyTorch, with the two crossbar
solve kernels written by hand in CUDA C++ for Hopper (`sm_90a`). It
imports torch, numpy and itself only. Entry points (`test_imac`,
`evaluate_batch`, `IMACNetwork`, `train_mlp`, `make_digits`) run on the
GPU unless given ``device="cpu"``; they raise when no GPU is present.
"""

__version__ = "0.1.0"
