"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds a wrapper that launches the CUDA kernel for CUDA
tensors (or raises) and runs the plain version in ``kernels.ref`` for CPU
tensors, plus a plain-integer launch counter ``LAUNCHES``.
"""
