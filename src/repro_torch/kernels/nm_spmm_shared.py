"""Wrapper of the Hopper ``nm_spmm_shared`` kernel
(``csrc/nm_spmm_shared.cu``).

Counterpart of ``src/repro/kernels/nm_spmm_shared.py:
nm_spmm_shared_pallas``: the shared-pattern reduced-K matmul.  For each
output tile j, the Kc activation columns ``rows[j]`` of act (B, K) are
gathered and contracted with vals[j] (Kc, TF), cast to act's dtype ->
(B, nf*TF) fp32.  Serving's ``SharedOp`` is one tile (nf = 1, TF = F);
``ops.pack_shared`` gives TF = 128.

What differs: the kernel gathers the survivor activations of a chunk of
Kc into shared memory and streams the weights as dense rows through
CUDA-core FMAs (the source note says why), with a Kc split planned from
the weight's shape only, so rows are bitwise independent of the batch;
it takes every B, Kc and TF (no VMEM panel limit, so no fallback to the
plain version).  This wrapper only launches: it checks device, dtype,
shape and contiguity and raises on anything else;
``kernels.ops.nm_spmm_shared`` sends CPU tensors to
``kernels.ref.ref_nm_spmm_shared`` instead.  ``launches`` counts the
launches made here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

BLOCK_F = 256         # output columns per block (kBlockF in the source)
TARGET_BLOCKS = 528   # four 4-warp blocks for each of the H100's 132 SMs
MAX_QUARTER = 64      # compact rows a warp takes from each staged chunk
MIN_QUARTER = 8
MAX_GRID_Z = 65535    # tiles x batch tiles ride the grid's z dimension
DTYPES = (torch.bfloat16, torch.float32)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("nm_spmm_shared")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nm_spmm_shared_launch.argtypes = [p, i, p, i, p, p, p, i, i, i,
                                              i, i, i, i, i, p]
        lib.nm_spmm_shared_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_plan(kc: int, tf: int, nf: int):
    """(quarter, chunks_per_split, splits) for vals (nf, Kc, TF).

    A block stages chunks of 4 * quarter compact rows (one quarter per
    warp) and a split covers ``chunks_per_split`` chunks.  The plan
    depends on the weight's shape only, never on the batch, so every row
    is summed in the same order whatever rides beside it.  Chunks shrink,
    and splits grow, until about ``TARGET_BLOCKS`` blocks fill the card.
    """
    col_blocks = -(-tf // BLOCK_F) * nf
    quarter = MAX_QUARTER
    while quarter > MIN_QUARTER and (col_blocks * -(-kc // (4 * quarter))
                                     < TARGET_BLOCKS):
        quarter //= 2
    n_chunks = -(-kc // (4 * quarter))
    want = max(1, min(n_chunks, -(-TARGET_BLOCKS // col_blocks)))
    chunks_per_split = -(-n_chunks // want)
    return quarter, chunks_per_split, -(-n_chunks // chunks_per_split)


def nm_spmm_shared(act: torch.Tensor, vals: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raises unless act (B, K), vals (nf, Kc, TF)
    and rows (nf, Kc) int32 are contiguous CUDA tensors, act and vals
    bf16 or fp32."""
    global launches
    for name, t, nd in (("act", act, 2), ("vals", vals, 3), ("rows", rows, 2)):
        if not t.is_cuda:
            raise ValueError(f"nm_spmm_shared: {name} is on {t.device}, not "
                             "CUDA")
        if t.device != act.device:
            raise ValueError(f"nm_spmm_shared: {name} is on {t.device}, act "
                             f"on {act.device}")
        if t.ndim != nd:
            raise ValueError(f"nm_spmm_shared: {name} must be {nd}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nm_spmm_shared: {name} must be contiguous")
    if act.dtype not in DTYPES or vals.dtype not in DTYPES:
        raise ValueError(f"nm_spmm_shared: act and vals must be bfloat16 or "
                         f"float32, got {act.dtype}, {vals.dtype}")
    if rows.dtype != torch.int32:
        raise ValueError(f"nm_spmm_shared: rows must be int32, got "
                         f"{rows.dtype}")
    b, k = act.shape
    nf, kc, tf = vals.shape
    if tuple(rows.shape) != (nf, kc):
        raise ValueError(f"nm_spmm_shared: rows shape {tuple(rows.shape)}, "
                         f"want {(nf, kc)}")
    if b == 0 or k == 0 or nf * kc * tf == 0:
        raise ValueError(f"nm_spmm_shared: empty product ({b}, {k}) x "
                         f"{tuple(vals.shape)}")
    if nf * -(-b // (4 if b <= 4 else 8)) > MAX_GRID_Z:
        raise ValueError(f"nm_spmm_shared: {nf} tiles x {b} rows exceed the "
                         "grid")
    lib = _library()
    quarter, chunks_per_split, splits = split_plan(kc, tf, nf)
    out = torch.empty((b, nf * tf), dtype=torch.float32, device=act.device)
    part = (torch.empty((splits, b, nf * tf), dtype=torch.float32,
                        device=act.device) if splits > 1 else out)
    stream = torch.cuda.current_stream(act.device).cuda_stream
    with torch.cuda.device(act.device):
        err = lib.nm_spmm_shared_launch(
            act.data_ptr(), int(act.dtype == torch.bfloat16),
            vals.data_ptr(), int(vals.dtype == torch.bfloat16),
            rows.data_ptr(), out.data_ptr(), part.data_ptr(), b, k, kc, tf,
            nf, quarter, chunks_per_split, splits, stream)
    if err != 0:
        raise RuntimeError(f"nm_spmm_shared: kernel launch failed, CUDA "
                           f"error {err}")
    launches += 1
    return out
