"""Kernels of the port (counterpart of ``src/repro/kernels/``).

``ops`` dispatches by device; ``nm_spmm`` and ``fused_update`` wrap the
hand-written Hopper kernels ``csrc/nm_spmm.cu`` and
``csrc/fused_update.cu``, built by ``build``; ``ref`` holds the plain
PyTorch versions that the CPU path runs and the card checks against.
"""
