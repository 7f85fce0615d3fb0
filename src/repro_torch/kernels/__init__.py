"""Kernels of the port (counterpart of ``src/repro/kernels/``).

``ops`` dispatches by device; ``nm_spmm`` wraps the hand-written Hopper
kernel ``csrc/nm_spmm.cu``, built by ``build``; ``ref`` holds the plain
PyTorch versions that the CPU path runs and the card checks against.
"""
