"""Kernel dispatch by device.

Counterpart of ``src/repro/kernels/ops.py:nm_compact``, ``:nm_spmm``,
``:nm_spmm_shared``, ``:fused_update``, ``:grad_compress``,
``:grad_decompress_mean``, ``:pack_shared`` and ``:packed_bytes``.  The
reference picks Pallas or its jnp oracle with a ``use_pallas`` flag and
routes shapes its tiles cannot split (an odd u4 compact tile, an
activation panel over its VMEM budget) to the oracle.  Here the tensor's
device decides: a CUDA tensor goes to the Hopper kernel (which takes
every shape, so there is no shape fallback), a CPU tensor to the plain
version in ``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_update as _fused_update
from repro_torch.kernels import grad_compress as _grad_compress
from repro_torch.kernels import nm_compact as _nm_compact
from repro_torch.kernels import nm_spmm as _nm_spmm
from repro_torch.kernels import nm_spmm_shared as _nm_spmm_shared
from repro_torch.kernels import ref


def nm_compact(x: torch.Tensor, n: int, m: int, idx_bits: int = 8, *,
               out=None):
    """SORE: pack (R, K) ``x`` N:M along its last axis -> (vals (R, Kc) in
    x's dtype, uint8 idx (R, Kc) or the u4 plane (R, ceil(Kc/2))).  ``x``
    may be a strided view; ``out`` = (vals, idx) views to write into."""
    if x.is_cuda:
        return _nm_compact.nm_compact(x, n, m, idx_bits, out=out)
    vals, idx = ref.ref_nm_compact(x, n, m, idx_bits)
    if out is None:
        return vals, idx
    return out[0].copy_(vals), out[1].copy_(idx)


def nm_spmm(act: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
            n: int, m: int, idx_bits: int = 8) -> torch.Tensor:
    """Element-mode sparse matmul: (B, K) @ packed (Kc, F) -> (B, F) fp32,
    or an expert stack (E, B, K) @ (E, Kc, F) -> (E, B, F) in one launch."""
    if act.is_cuda:
        return _nm_spmm.nm_spmm(act, vals, idx, n, m, idx_bits)
    return ref.ref_nm_spmm(act, vals, idx, n, m, idx_bits)


def nm_spmm_shared(act: torch.Tensor, vals: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """Shared-pattern reduced-K matmul: act (B, K), vals (nf, Kc, TF), rows
    (nf, Kc) int32 -> (B, nf*TF) fp32."""
    if act.is_cuda:
        return _nm_spmm_shared.nm_spmm_shared(act, vals, rows)
    return ref.ref_nm_spmm_shared(act, vals, rows)


def fused_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                 lr: float, mu: float, wd: float, lam: float, n: int, m: int):
    """Momentum SGD + SR-STE decay + N:M pre-generation of a (K, F) fp32
    master, groups along K: (w', v', vals (K*n/m, F) bf16, idx uint8)."""
    if w.is_cuda:
        return _fused_update.fused_update(w, g, v, lr, mu, wd, lam, n, m)
    return ref.ref_fused_update(w, g, v, lr=lr, mu=mu, wd=wd, lam=lam, n=n,
                                m=m, axis=0)


def fused_update_sites(sites, lr: float, mu: float, wd: float, lam: float,
                       n: int, m: int, bp_mode, *, inplace: bool = False):
    """``fused_update`` of every (w, g, v) of ``sites`` ((K, F) fp32
    master and momentum, g bf16 or fp32), each with its BP operand and FF
    mask when ``bp_mode`` is "bdwp" or "srste": per site (w', v', vals,
    idx[, bp (K, F) bf16, FF mask (K, F) bool]).  ``inplace`` writes w'
    and v' over w and v.  On the card one launch covers all the sites;
    on the CPU the plain version runs site by site."""
    if sites and sites[0][0].is_cuda:
        return _fused_update.fused_update_sites(sites, lr, mu, wd, lam, n,
                                                m, bp_mode, inplace=inplace)
    outs = []
    for w, g, v in sites:
        out = ref.ref_fused_update(w, g, v, lr=lr, mu=mu, wd=wd, lam=lam,
                                   n=n, m=m, axis=0, bp_mode=bp_mode)
        if inplace:
            out = (w.copy_(out[0]), v.copy_(out[1]), *out[2:])
        outs.append(out)
    return outs


def grad_compress(g: torch.Tensor, err: torch.Tensor, n: int, m: int):
    """Error-feedback N:M compress of (R, K) gradient rows (bf16 or fp32)
    and their fp32 residual: (vals (R, K*n/m) bf16, idx uint8, err'),
    err' written over ``err`` and returned as it.  Rows may be strided
    views."""
    if g.is_cuda:
        return _grad_compress.grad_compress(g, err, n, m, out_err=err)
    vals, idx, new_err = ref.ref_grad_compress(g, err, n, m)
    return vals, idx, err.copy_(new_err)


def grad_decompress_mean(vals: torch.Tensor, idx: torch.Tensor, n: int,
                         m: int, out: torch.Tensor) -> torch.Tensor:
    """Pod mean of (P, Kc) packed payloads, written into the (Kc*m/n,)
    ``out`` (bf16 or fp32) and returned as it."""
    if vals.is_cuda:
        return _grad_compress.grad_decompress_mean(vals, idx, n, m, out=out)
    return out.copy_(ref.ref_grad_decompress_mean(vals, idx, n, m))


def pack_shared(w: torch.Tensor, n: int, m: int, tile: int = 128):
    """Shared-mode packer: (K, F) -> (vals (nf, Kc, tile), rows (nf, Kc)
    int32), nf = F / tile.  Each tile's pattern is the N:M selection
    (``nm_compact``) over its per-row score, the summed |w| of the tile's
    columns in fp32, so it agrees exactly with ``core.sparsity.
    nm_mask_shared`` (``sparsify(granularity="shared")``)."""
    k, f = w.shape
    if f % tile or k % m:
        raise ValueError(f"pack_shared: ({k}, {f}) does not tile into "
                         f"{tile} columns and {m}-groups")
    nf = f // tile
    wt = w.reshape(k, nf, tile)
    score = wt.abs().to(torch.float32).sum(-1)              # (K, nf)
    _, offsets = nm_compact(score.t(), n, m)                # (nf, Kc)
    rows = group_rows(offsets, n, m)
    vals = torch.gather(wt.permute(1, 0, 2), 1,
                        rows.long()[..., None].expand(-1, -1, tile))
    return vals, rows


def group_rows(offsets: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Absolute K rows (..., Kc) int32 of compact in-group ``offsets``
    (..., Kc), n per m-group: group * m + offset."""
    kc = offsets.shape[-1]
    base = torch.arange(kc // n, dtype=torch.int32,
                        device=offsets.device).repeat_interleave(n) * m
    return base + offsets.to(torch.int32)


def packed_bytes(k: int, f: int, n: int, m: int, dtype_bytes: int = 2,
                 idx_bits: int = 8) -> int:
    """Device bytes of an element-mode packed (K, F) weight."""
    kc = k // m * n
    return kc * f * dtype_bytes + kc * f * idx_bits // 8
