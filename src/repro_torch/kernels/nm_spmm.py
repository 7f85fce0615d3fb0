"""Wrapper of the Hopper ``nm_spmm`` kernel (``csrc/nm_spmm.cu``).

Counterpart of ``src/repro/kernels/nm_spmm.py:nm_spmm_pallas``: act
(B, K) bf16 @ packed weights vals (Kc = K*n/m, F) bf16 with idx uint8
(Kc, F) or the u4 plane (ceil(Kc/2), F) -> (B, F) fp32.

What differs: the kernel is a survivor-gather FMA over the compact
operand, not a VMEM tile decompress plus MXU product (the source note
says why), and it takes every shape the reference's oracle takes — an
odd Kc with u4 indices included — so the port has no fallback to the
plain version for awkward shapes.  This wrapper only launches: it
checks device, dtype, shape and contiguity and raises on anything else;
``kernels.ops.nm_spmm`` sends CPU tensors to ``kernels.ref`` instead.
``launches`` counts the launches made here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

BLOCK_F = 256         # output columns per block (kBlockF in the source)
TARGET_BLOCKS = 528   # four 4-warp blocks for each of the H100's 132 SMs
MAX_CHUNK_K = 1024    # dense K columns staged in shared memory per chunk

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("nm_spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nm_spmm_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                       i, i, i, p]
        lib.nm_spmm_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_plan(k: int, f: int, m: int):
    """(quarter, chunks_per_split, splits) for a (K, F) weight.

    A block stages chunks of 4 * quarter m-groups (one quarter per warp;
    ``quarter`` is even so that u4 rows pair up) and a split covers
    ``chunks_per_split`` chunks.  The plan depends on the weight's shape
    only, never on the batch, so every row is summed in the same order
    whatever rides beside it.  Chunks shrink, and splits grow, until
    about ``TARGET_BLOCKS`` blocks fill the card.
    """
    groups = k // m
    col_blocks = -(-f // BLOCK_F)
    quarter = max(2, min(16, MAX_CHUNK_K // (4 * m)) // 2 * 2)
    while quarter > 2 and (col_blocks * -(-groups // (4 * quarter))
                           < TARGET_BLOCKS):
        quarter //= 2
    n_chunks = -(-groups // (4 * quarter))
    want = max(1, min(n_chunks, -(-TARGET_BLOCKS // col_blocks)))
    chunks_per_split = -(-n_chunks // want)
    return quarter, chunks_per_split, -(-n_chunks // chunks_per_split)


def nm_spmm(act: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
            n: int, m: int, idx_bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel; raises unless every operand is a
    contiguous CUDA tensor of the kernel's dtype and shape."""
    global launches
    for name, t in (("act", act), ("vals", vals), ("idx", idx)):
        if not t.is_cuda:
            raise ValueError(f"nm_spmm: {name} is on {t.device}, not CUDA")
        if t.device != act.device:
            raise ValueError(f"nm_spmm: {name} is on {t.device}, act on "
                             f"{act.device}")
        if t.ndim != 2:
            raise ValueError(f"nm_spmm: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nm_spmm: {name} must be contiguous")
    if act.dtype != torch.bfloat16 or vals.dtype != torch.bfloat16:
        raise ValueError(f"nm_spmm: act and vals must be bfloat16, got "
                         f"{act.dtype}, {vals.dtype}")
    if idx.dtype != torch.uint8:
        raise ValueError(f"nm_spmm: idx must be uint8, got {idx.dtype}")
    if idx_bits not in (4, 8):
        raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
    if not 0 < n <= m or m > (16 if idx_bits == 4 else 128):
        raise ValueError(f"nm_spmm: unsupported {n}:{m} with "
                         f"{idx_bits}-bit indices")
    b, k = act.shape
    kc, f = vals.shape
    if k % m or kc * m != k * n:
        raise ValueError(f"nm_spmm: K={k}, Kc={kc} do not match {n}:{m}")
    want = (kc, f) if idx_bits == 8 else ((kc + 1) // 2, f)
    if tuple(idx.shape) != want:
        raise ValueError(f"nm_spmm: idx shape {tuple(idx.shape)}, "
                         f"want {want}")
    if b == 0 or f == 0:
        raise ValueError(f"nm_spmm: empty product ({b}, {k}) x ({k}, {f})")
    lib = _library()
    quarter, chunks_per_split, splits = split_plan(k, f, m)
    out = torch.empty((b, f), dtype=torch.float32, device=act.device)
    part = (torch.empty((splits, b, f), dtype=torch.float32,
                        device=act.device) if splits > 1 else out)
    stream = torch.cuda.current_stream(act.device).cuda_stream
    with torch.cuda.device(act.device):
        err = lib.nm_spmm_launch(
            act.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
            part.data_ptr(), b, k, f, kc, n, m, idx_bits, quarter,
            chunks_per_split, splits, stream)
    if err != 0:
        raise RuntimeError(f"nm_spmm: kernel launch failed, CUDA error {err}")
    launches += 1
    return out
