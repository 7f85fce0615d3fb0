"""Wrappers of the Hopper ``grad_compress`` and ``grad_decompress_mean``
kernels (``csrc/grad_compress.cu``).

Counterparts of ``src/repro/kernels/grad_compress.py``:
``grad_compress_pallas`` (error-feedback N:M compress of gradient rows,
the bf16 wire rounding folded into the residual) and
``grad_decompress_mean_pallas`` (the pod mean of P packed payloads).
The functions are the plain versions ``kernels.ref.ref_grad_compress``
and ``ref_grad_decompress_mean``, bit for bit.

What differs: rows may be strided views (unit stride along K, any row
stride), so the sync hands a bucket of a pod-stacked leaf and a column
range of the residual to the kernel without copying them; the new
residual may be written over the old one (``out_err=err``); the mean is
written straight into a caller's buffer in the gradient's dtype
(``out=``).  These wrappers only launch: they check device, dtype,
shape and strides and raise on anything else; ``kernels.ops`` sends
CPU tensors to the plain versions instead.

Each kernel has two hand-written variants with the same bits: "vector"
(16-byte accesses, a persistent grid, the payload staged in shared
memory) where every row of the dense operands (g, err, err'; the mean's
output) starts on a multiple of one m-group's bytes (at most 16), and
"scalar" (one thread per group, scalar accesses) for any other
alignment; ``variant="auto"`` picks the vector one where it may run.
``launches`` counts the launches made here and nowhere else, one
counter per kernel, and ``variant_launches`` the same launches per
variant.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import inv_pods

launches = {"grad_compress": 0, "grad_decompress_mean": 0}
VARIANTS = ("vector", "scalar")
variant_launches = {k: dict.fromkeys(VARIANTS, 0) for k in launches}
GROUP_SIZES = (2, 4, 8, 16)   # the m the kernels are instantiated for
MAX_ROWS = 65535              # rows ride the grid's y dimension

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("grad_compress")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.grad_compress_launch.argtypes = [p, i64, i, p, i64, p, i64, p, p,
                                             i, i64, i, i, i, p]
        lib.grad_compress_launch.restype = ctypes.c_int
        lib.grad_decompress_mean_launch.argtypes = [
            p, i64, p, i64, p, i, i, i64, i, i, ctypes.c_float, i, p]
        lib.grad_decompress_mean_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_rows(op, name, t, dtypes, like):
    if not t.is_cuda:
        raise ValueError(f"{op}: {name} is on {t.device}, not CUDA")
    if t.device != like.device:
        raise ValueError(f"{op}: {name} is on {t.device}, not {like.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{op}: {name} must be one of {dtypes}, got "
                         f"{t.dtype}")
    if t.ndim != 2 or t.shape != like.shape:
        raise ValueError(f"{op}: {name} must be 2-D of shape "
                         f"{tuple(like.shape)}, got {tuple(t.shape)}")
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{op}: {name} rows must be dense along K "
                         f"(strides {t.stride()})")


def _aligned(t: torch.Tensor, m: int) -> bool:
    """May the vector variant take 2-D (or 1-D) ``t``: does every row
    start on a multiple of one m-group's bytes (at most 16)?"""
    a = min(16, m * t.element_size())
    rows_ok = t.ndim == 1 or t.shape[0] == 1 or (
        t.stride(0) * t.element_size()) % a == 0
    return t.data_ptr() % a == 0 and rows_ok


def _pick(op, variant, aligned: bool) -> str:
    if variant == "auto":
        return "vector" if aligned else "scalar"
    if variant not in VARIANTS:
        raise ValueError(f"{op}: variant must be 'auto' or one of "
                         f"{VARIANTS}, got {variant!r}")
    if variant == "vector" and not aligned:
        raise ValueError(f"{op}: the vector variant needs rows aligned to "
                         "one m-group (at most 16 bytes)")
    return variant


def _check_nm(op, n, m, k):
    if m not in GROUP_SIZES or not 0 < n <= m:
        raise ValueError(f"{op}: unsupported {n}:{m} (m in {GROUP_SIZES})")
    if k <= 0 or k % m:
        raise ValueError(f"{op}: K={k} is not a positive multiple of m={m}")


def grad_compress(g: torch.Tensor, err: torch.Tensor, n: int, m: int, *,
                  out_err: torch.Tensor | None = None,
                  variant: str = "auto"):
    """Launch the compress kernel on (R, K) ``g`` (bf16 or fp32) and fp32
    ``err``; returns (vals (R, K*n/m) bf16, idx uint8, err').  err' is
    written into ``out_err`` (which may be ``err`` itself) when given,
    else into a new tensor.  ``variant``: "auto", "vector" or
    "scalar"."""
    op = "grad_compress"
    _check_rows(op, "g", g, (torch.bfloat16, torch.float32), g)
    _check_rows(op, "err", err, (torch.float32,), g)
    if out_err is None:
        out_err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    _check_rows(op, "out_err", out_err, (torch.float32,), g)
    r, k = g.shape
    _check_nm(op, n, m, k)
    if not 0 < r <= MAX_ROWS:
        raise ValueError(f"{op}: {r} rows, want 1..{MAX_ROWS}")
    kind = _pick(op, variant, all(_aligned(t, m) for t in (g, err, out_err)))
    lib = _library()
    kc = k // m * n
    vals = torch.empty((r, kc), dtype=torch.bfloat16, device=g.device)
    idx = torch.empty((r, kc), dtype=torch.uint8, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        rc = lib.grad_compress_launch(
            g.data_ptr(), g.stride(0), int(g.dtype == torch.bfloat16),
            err.data_ptr(), err.stride(0), out_err.data_ptr(),
            out_err.stride(0), vals.data_ptr(), idx.data_ptr(), r, k, n, m,
            int(kind == "vector"), stream)
    if rc != 0:
        raise RuntimeError(f"{op}: kernel launch failed, CUDA error {rc}")
    launches[op] += 1
    variant_launches[op][kind] += 1
    return vals, idx, out_err


def grad_decompress_mean(vals: torch.Tensor, idx: torch.Tensor, n: int,
                         m: int, *, out: torch.Tensor | None = None,
                         variant: str = "auto"):
    """Launch the pod-mean kernel on (P, Kc) bf16 ``vals`` and uint8
    ``idx``; returns the (Kc*m/n,) mean in ``out`` (contiguous, bf16 or
    fp32) when given, else in a new fp32 tensor.  ``variant``: "auto",
    "vector" or "scalar"."""
    op = "grad_decompress_mean"
    _check_rows(op, "vals", vals, (torch.bfloat16,), vals)
    _check_rows(op, "idx", idx, (torch.uint8,), vals)
    p, kc = vals.shape
    if kc % n:
        raise ValueError(f"{op}: Kc={kc} not divisible by n={n}")
    k = kc // n * m
    _check_nm(op, n, m, k)
    if out is None:
        out = torch.empty((k,), dtype=torch.float32, device=vals.device)
    if (not out.is_cuda or out.device != vals.device
            or out.dtype not in (torch.bfloat16, torch.float32)
            or out.shape != (k,) or not out.is_contiguous()):
        raise ValueError(f"{op}: out must be a contiguous ({k},) bf16 or "
                         f"fp32 tensor on {vals.device}")
    kind = _pick(op, variant, _aligned(out, m))
    lib = _library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        rc = lib.grad_decompress_mean_launch(
            vals.data_ptr(), vals.stride(0), idx.data_ptr(), idx.stride(0),
            out.data_ptr(), int(out.dtype == torch.bfloat16), p, kc, n, m,
            inv_pods(p), int(kind == "vector"), stream)
    if rc != 0:
        raise RuntimeError(f"{op}: kernel launch failed, CUDA error {rc}")
    launches[op] += 1
    variant_launches[op][kind] += 1
    return out
