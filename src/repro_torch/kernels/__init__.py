"""Kernels of the port: each a hand-written Hopper kernel beside its plain
PyTorch version (see ``build`` for how the CUDA sources are built)."""
