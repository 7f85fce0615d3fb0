"""Kernel dispatch by device.

Counterpart of ``src/repro/kernels/ops.py:nm_spmm``, ``:fused_update``,
``:grad_compress`` and ``:grad_decompress_mean``.  The reference picks
Pallas or its jnp oracle with a ``use_pallas`` flag and routes shapes
its tiles cannot split (an odd u4 compact tile) to the oracle.  Here the tensor's device decides: a CUDA
tensor goes to the Hopper kernel (which takes every shape, so there is
no shape fallback), a CPU tensor to the plain version in
``kernels.ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_update as _fused_update
from repro_torch.kernels import grad_compress as _grad_compress
from repro_torch.kernels import nm_spmm as _nm_spmm
from repro_torch.kernels import ref


def nm_spmm(act: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
            n: int, m: int, idx_bits: int = 8) -> torch.Tensor:
    """Element-mode sparse matmul: (B, K) @ packed (Kc, F) -> (B, F) fp32."""
    if act.is_cuda:
        return _nm_spmm.nm_spmm(act, vals, idx, n, m, idx_bits)
    return ref.ref_nm_spmm(act, vals, idx, n, m, idx_bits)


def fused_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                 lr: float, mu: float, wd: float, lam: float, n: int, m: int):
    """Momentum SGD + SR-STE decay + N:M pre-generation of a (K, F) fp32
    master, groups along K: (w', v', vals (K*n/m, F) bf16, idx uint8)."""
    if w.is_cuda:
        return _fused_update.fused_update(w, g, v, lr, mu, wd, lam, n, m)
    return ref.ref_fused_update(w, g, v, lr=lr, mu=mu, wd=wd, lam=lam, n=n,
                                m=m, axis=0)


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
