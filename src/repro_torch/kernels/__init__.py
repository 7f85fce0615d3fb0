"""Kernels of the port (counterpart of ``src/repro/kernels/``).

``ops`` dispatches by device; ``nm_spmm``, ``fused_update`` and
``grad_compress`` wrap the hand-written Hopper kernels
``csrc/nm_spmm.cu``, ``csrc/fused_update.cu`` and
``csrc/grad_compress.cu`` (``grad_compress`` and
``grad_decompress_mean``), built by ``build``; ``ref`` holds the plain
PyTorch versions that the CPU path runs and the card checks against.
"""
