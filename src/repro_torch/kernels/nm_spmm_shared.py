"""Wrapper of the Hopper ``nm_spmm_shared`` kernel
(``csrc/nm_spmm_shared.cu``).

Counterpart of ``src/repro/kernels/nm_spmm_shared.py:
nm_spmm_shared_pallas``: the shared-pattern reduced-K matmul.  For each
output tile j, the Kc activation columns ``rows[j]`` of act (B, K) are
gathered and contracted with vals[j] (Kc, TF), cast to act's dtype ->
(B, nf*TF) fp32.  Serving's ``SharedOp`` is one tile (nf = 1, TF = F);
``ops.pack_shared`` gives TF = 128.

bf16 act and vals (every serving path) run on the tensor cores: the
kernel's own gather pass writes the survivor columns into scratch, then
a pipelined wgmma product takes the weight as the A operand and the
batch rows as N; bytes bound it at decode and at prefill rows (the
source note says why).  ``plan`` is the launch plan, a pure function of
the shapes: Kc is cut into chunks fixed by Kc, each one tensor-core
accumulator chain, folded in ascending order in registers or, when the
grid is short, through per-chunk scratch and a second pass, so the
tile, stage width and split that B picks never change a row's bits.  fp32 act or vals (ragged callers, no main path) compute
another function and keep the CUDA-core FMA path, planned by
``fp32_split_plan``; the dtype alone decides.  It takes every B, Kc and
TF (no VMEM panel limit, so no fallback to the plain version).  This
wrapper only launches: it checks device, dtype, shape and contiguity and
raises on anything else; ``kernels.ops.nm_spmm_shared`` sends CPU
tensors to ``kernels.ref.ref_nm_spmm_shared`` instead.  ``launches``
counts the launches made here and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import nm_spmm as _spmm

launches = 0

MAX_GRID = 65535      # rows (y) and fp32 tiles x batch tiles (z)
# the CUDA-core fp32 path
BLOCK_F = 256         # output columns per block (kBlockF in the source)
TARGET_BLOCKS = 528   # four 4-warp blocks for each of the H100's 132 SMs
MAX_QUARTER = 64      # compact rows a warp takes from each staged chunk
MIN_QUARTER = 8
DTYPES = (torch.bfloat16, torch.float32)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("nm_spmm_shared")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nm_spmm_shared_launch.argtypes = [p] * 6 + [i] * 11 + [p]
        lib.nm_spmm_shared_launch.restype = ctypes.c_int
        lib.nm_spmm_shared_fp32_launch.argtypes = [p, i, p, i, p, p, p, i, i,
                                                   i, i, i, i, i, i, p]
        lib.nm_spmm_shared_fp32_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


class Plan(NamedTuple):
    tk: int                # compact rows a stage covers
    n_stages: int
    chunk_rows: int        # compact rows a chunk covers (Kc only)
    chunk_stages: int
    n_chunks: int
    config: int            # index into nm_spmm.CONFIGS (chosen by B)
    splits: int            # blocks along Kc
    chunks_per_split: int
    scratch_floats: int    # per-chunk partials, 0 when not split


SLOTS, A_SLOTS = 4, 3   # the TMA ring and the transposed A tiles


def smem_bytes(config: int, tk: int) -> int:
    """Shared memory of one tensor-core block (the source's
    ``SharedLayout``)."""
    bm, bn, _ = _spmm.tile(config)
    stage = _spmm._up1k(tk * bm * 2) + _spmm._up1k(bn * tk * 2)
    return (SLOTS * stage + A_SLOTS * bm * tk * 2
            + 2 * (SLOTS + A_SLOTS) * 8 + 1024)


def chunk_rows(kc: int) -> int:
    """Compact rows of a chunk: a whole number of every stage width,
    at least CHUNK_K rows, at most MAX_CHUNKS chunks.  Kc only."""
    unit = 128
    return unit * max(-(-_spmm.CHUNK_K // unit),
                      -(-kc // (_spmm.MAX_CHUNKS * unit)))


def plan(b: int, kc: int, tf: int, nf: int) -> Plan:
    """The tensor-core launch plan of act (B, K) x vals (nf, Kc, TF).

    The chunks depend on Kc only: each is one tensor-core accumulator
    chain and they are folded in order, so what B picks (the tile
    configuration, the stage width, the split) never changes a bit.
    """
    cr = chunk_rows(kc)
    n_chunks = -(-kc // cr)
    config = _spmm.pick_config(b, nf * tf)
    for tk in (_spmm.CONFIGS[config][3], 64):
        if smem_bytes(config, tk) <= _spmm.MAX_SMEM:
            break
    bm, bn, _ = _spmm.tile(config)
    splits, cps = _spmm.split_k(config, nf * -(-tf // bm) * -(-b // bn),
                                n_chunks)
    return Plan(tk, -(-kc // tk), cr, cr // tk, n_chunks, config, splits,
                cps, n_chunks * b * nf * tf if splits > 1 else 0)


def fp32_split_plan(kc: int, tf: int, nf: int):
    """(quarter, chunks_per_split, splits) of the CUDA-core path for vals
    (nf, Kc, TF).

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
    bf16 = act.dtype == vals.dtype == torch.bfloat16
    if b > MAX_GRID or nf > MAX_GRID or (
            not bf16 and nf * -(-b // (4 if b <= 4 else 8)) > MAX_GRID):
        raise ValueError(f"nm_spmm_shared: {nf} tiles x {b} rows exceed the "
                         "grid")
    lib = _library()
    out = torch.empty((b, nf * tf), dtype=torch.float32, device=act.device)
    stream = torch.cuda.current_stream(act.device).cuda_stream
    if bf16:
        pl = plan(b, kc, tf, nf)
        act_g = torch.empty(nf * b * (-(-kc // 8) * 8), dtype=torch.bfloat16,
                            device=act.device)
        part = (torch.empty(pl.scratch_floats, dtype=torch.float32,
                            device=act.device) if pl.splits > 1 else out)
        with torch.cuda.device(act.device):
            err = lib.nm_spmm_shared_launch(
                act.data_ptr(), vals.data_ptr(), rows.data_ptr(),
                act_g.data_ptr(), out.data_ptr(), part.data_ptr(), b, k, kc,
                tf, nf, pl.config, pl.tk, pl.n_stages, pl.chunk_stages,
                pl.chunks_per_split, pl.splits, stream)
    else:
        quarter, chunks_per_split, splits = fp32_split_plan(kc, tf, nf)
        part = (torch.empty((splits, b, nf * tf), dtype=torch.float32,
                            device=act.device) if splits > 1 else out)
        with torch.cuda.device(act.device):
            err = lib.nm_spmm_shared_fp32_launch(
                act.data_ptr(), int(act.dtype == torch.bfloat16),
                vals.data_ptr(), int(vals.dtype == torch.bfloat16),
                rows.data_ptr(), out.data_ptr(), part.data_ptr(), b, k, kc,
                tf, nf, quarter, chunks_per_split, splits, stream)
    if err != 0:
        raise RuntimeError(f"nm_spmm_shared: kernel launch failed, CUDA "
                           f"error {err}")
    launches += 1
    return out
