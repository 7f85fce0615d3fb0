"""Wrapper of the Hopper ``nm_spmm`` kernel (``csrc/nm_spmm.cu``).

Counterpart of ``src/repro/kernels/nm_spmm.py:nm_spmm_pallas``: act
(B, K) bf16 @ packed weights vals (Kc = K*n/m, F) bf16 with idx uint8
(Kc, F) or the u4 plane (ceil(Kc/2), F) -> (B, F) fp32.  A stack of
them (MoE experts: act (E, B, K), vals and idx (E, ·, F) -> (E, B, F))
is one launch with the expert in the grid, where the reference vmaps
its kernel over the experts (``core/operand.py:_spmm_stacked``); each
expert's slab is bitwise the 2-D launch on that expert alone.

The kernel decompresses staged compact tiles in shared memory and runs
the product on the tensor cores (wgmma, the weight tile as the A
operand, the batch rows as N), expanding the next tile while the
current product runs; the source note says why.
It is bound by bytes at decode and by operations at training rows.
``plan`` is the launch plan, a pure function of the shapes: K is cut
into chunks fixed by (K, m), each one tensor-core accumulator chain,
folded in ascending order in registers or, when the grid is short,
through per-chunk scratch and a second pass, so the tile, stage width
and split that B picks never change a row's bits.  It takes every shape the reference's oracle takes (an odd
Kc with u4 indices included), so the port has no fallback to the plain
version.  This wrapper only launches: it checks device, dtype, shape and
contiguity and raises on anything else; ``kernels.ops.nm_spmm`` sends
CPU tensors to ``kernels.ref`` instead.  ``launches`` counts the
launches made here and nowhere else.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

launches = 0

# tile configurations (PWG, CWG, N, stage width): PWG producer warpgroups
# (TMA and the expand), CWG consumer warpgroups (wgmma) owning BM = 64 *
# CWG output columns, N batch rows (the wgmma N), stages of that many
# dense K columns (the source's kConfigs)
CONFIGS = ((2, 1, 8, 128), (2, 1, 32, 128), (2, 2, 64, 64), (2, 2, 128, 64))
CHUNK_K = 256           # dense K columns a chunk covers, at least
MAX_CHUNKS = 16         # chunks grow past CHUNK_K to keep at most this many
SM_COUNT = 132          # H100 SXM
# a grid of this many blocks is not split: two per SM where bytes bound
# the product (decode, B <= 32), about one where operations do
FULL_BLOCKS = (2 * SM_COUNT, 2 * SM_COUNT, SM_COUNT - 12, SM_COUNT - 12)
TARGET_BLOCKS = 2 * SM_COUNT   # a split grid aims at this many
MAX_SMEM = 232448

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("nm_spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nm_spmm_launch.argtypes = [p] * 5 + [i] * 15 + [p]
        lib.nm_spmm_launch.restype = ctypes.c_int
        lib.nm_spmm_smem_bytes.argtypes = [i] * 4
        lib.nm_spmm_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


class Plan(NamedTuple):
    gs: int                # m-groups a stage covers
    sk: int                # dense K columns a stage covers (gs * m)
    tk: int                # the stage's tile width (sk rounded up to 64)
    cr: int                # compact rows a stage covers (gs * n)
    n_stages: int
    chunk_groups: int      # m-groups a chunk covers (K, n, m only)
    chunk_stages: int      # stages a chunk covers
    n_chunks: int
    config: int            # index into CONFIGS (chosen by B)
    splits: int            # blocks along K
    chunks_per_split: int
    scratch_floats: int    # per-chunk partials of every expert, 0 when
                           # not split


def sparse_ok(n: int, m: int) -> bool:
    """Every aligned 4-group of an n:m group holds at most 2 survivors,
    so the group would be a valid operand of the 2:4 sparse tensor cores
    (the path ROADMAP queue 2 lists; this kernel has the dense tile)."""
    return n <= 2 and m % 4 == 0


def tile(config: int):
    """(BM output columns, BN rows, threads) of a configuration."""
    pwg, cwg, n_rows, _ = CONFIGS[config]
    return 64 * cwg, n_rows, 128 * (pwg + cwg)


def _up1k(x: int) -> int:
    return -(-x // 1024) * 1024


def smem_bytes(config: int, tk: int, cr: int) -> int:
    """Shared memory of one block (the source's ``Layout``: 1024-byte
    aligned regions, and 1024 bytes to align the base)."""
    bm, bn, _ = tile(config)
    slots, a_slots = (4, 3) if bm == 64 else (6, 4)
    stage = _up1k(bn * tk * 2) + _up1k(cr * bm * 2) + _up1k(cr * bm)
    return (slots * stage + a_slots * bm * tk * 2
            + 2 * (slots + a_slots) * 8 + 1024)


def stage_groups(width: int, m: int) -> int:
    """m-groups of a stage ``width`` dense columns wide where m divides
    it, else the fewest groups that span 64 columns."""
    return width // m if width % m == 0 else -(-64 // m)


def chunk_groups(k: int, m: int) -> int:
    """m-groups of a chunk: a whole number of every configuration's
    stages, at least CHUNK_K dense columns, at most MAX_CHUNKS chunks.
    A function of the weight's shape only."""
    unit = 1
    for width in {c[3] for c in CONFIGS} | {64}:
        unit = math.lcm(unit, stage_groups(width, m))
    groups = k // m
    return unit * max(1, -(-CHUNK_K // (unit * m)),
                      -(-groups // (MAX_CHUNKS * unit)))


def pick_config(b: int, f: int, stack: int = 1) -> int:
    """Tile configuration by batch rows (and, at training rows, the grid
    over F and the ``stack`` experts).  Never changes a result's bits."""
    if b <= 8:
        return 0
    if b <= 32:
        return 1
    if b < 512:
        return 2
    for config in (3, 2):
        bm, bn, _ = tile(config)
        if stack * -(-f // bm) * -(-b // bn) >= FULL_BLOCKS[config]:
            return config
    return 3


def split_k(config: int, blocks: int, n_chunks: int):
    """(splits, chunks_per_split): no split when the grid fills the card,
    else enough splits to approach ``TARGET_BLOCKS``, each split a run of
    whole chunks."""
    if blocks >= FULL_BLOCKS[config]:
        return 1, n_chunks
    want = min(n_chunks, -(-TARGET_BLOCKS // blocks))
    cps = -(-n_chunks // want)
    return -(-n_chunks // cps), cps


def plan(b: int, k: int, f: int, n: int, m: int, stack: int = 1) -> Plan:
    """The launch plan of (B, K) @ packed (K, F) n:m, for each of
    ``stack`` experts.

    The chunks (``chunk_groups``) depend on (K, m) only: each is one
    tensor-core accumulator chain and the chunks are folded in order, so
    what B and the stack pick (the tile configuration, the stage width,
    whether the chunks are split across blocks) never changes a result's
    bits.
    Where a configuration's stages would not fit in shared memory,
    narrower stages or a smaller configuration do.
    """
    groups = k // m
    cg = chunk_groups(k, m)
    n_chunks = -(-groups // cg)
    config = pick_config(b, f, stack)
    while True:
        bm, bn, _ = tile(config)
        for width in (CONFIGS[config][3], 64):
            gs = stage_groups(width, m)
            sk = gs * m
            tk = -(-sk // 64) * 64
            if smem_bytes(config, tk, gs * n) <= MAX_SMEM:
                splits, cps = split_k(
                    config, stack * -(-f // bm) * -(-b // bn), n_chunks)
                return Plan(gs, sk, tk, gs * n, -(-groups // gs), cg,
                            cg // gs, n_chunks, config, splits, cps,
                            n_chunks * stack * b * f if splits > 1 else 0)
        if config == 0:
            raise ValueError(f"nm_spmm: {n}:{m} stages do not fit in "
                             "shared memory")
        config -= 1


def nm_spmm(act: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
            n: int, m: int, idx_bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel; raises unless every operand is a
    contiguous CUDA tensor of the kernel's dtype and shape: all 2-D, or
    all 3-D stacks of the same number of experts."""
    global launches
    for name, t in (("act", act), ("vals", vals), ("idx", idx)):
        if not t.is_cuda:
            raise ValueError(f"nm_spmm: {name} is on {t.device}, not CUDA")
        if t.device != act.device:
            raise ValueError(f"nm_spmm: {name} is on {t.device}, act on "
                             f"{act.device}")
        if t.ndim not in (2, 3) or t.ndim != act.ndim:
            raise ValueError(f"nm_spmm: {name} must be 2-D, or a 3-D stack "
                             f"as act is, got {tuple(t.shape)}")
        if t.shape[:-2] != act.shape[:-2]:
            raise ValueError(f"nm_spmm: {name} stacks {tuple(t.shape)[:-2]},"
                             f" act {tuple(act.shape)[:-2]}")
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
    e = act.shape[0] if act.ndim == 3 else 1
    b, k = act.shape[-2:]
    kc, f = vals.shape[-2:]
    if k % m or kc * m != k * n:
        raise ValueError(f"nm_spmm: K={k}, Kc={kc} do not match {n}:{m}")
    want = (kc, f) if idx_bits == 8 else ((kc + 1) // 2, f)
    if tuple(idx.shape[-2:]) != want:
        raise ValueError(f"nm_spmm: idx shape {tuple(idx.shape)}, "
                         f"want {want}")
    if b == 0 or f == 0 or e == 0:
        raise ValueError(f"nm_spmm: empty product {e} x ({b}, {k}) x "
                         f"({k}, {f})")
    if b > 65535 * 8:
        raise ValueError(f"nm_spmm: {b} rows exceed the grid")
    pl = plan(b, k, f, n, m, e)
    if e * pl.splits > 65535:
        raise ValueError(f"nm_spmm: {e} experts x {pl.splits} splits exceed "
                         "the grid")
    lib = _library()
    out = torch.empty((*act.shape[:-1], f), dtype=torch.float32,
                      device=act.device)
    part = (torch.empty(pl.scratch_floats, dtype=torch.float32,
                        device=act.device) if pl.splits > 1 else out)
    stream = torch.cuda.current_stream(act.device).cuda_stream
    with torch.cuda.device(act.device):
        err = lib.nm_spmm_launch(
            act.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
            part.data_ptr(), e, b, k, f, kc, n, m, idx_bits, pl.config, pl.gs,
            pl.tk, pl.n_stages, pl.chunk_stages, pl.chunks_per_split,
            pl.splits, stream)
    if err != 0:
        raise RuntimeError(f"nm_spmm: kernel launch failed, CUDA error {err}")
    launches += 1
    return out
