"""Wrapper of the Hopper ``fused_update`` kernel (``csrc/fused_update.cu``).

Counterpart of ``src/repro/kernels/fused_update.py:fused_update_pallas``:
one pass over a fp32 master weight updates it and its momentum (SR-STE
decay from the pre-update N:M mask, momentum SGD) and emits the SORE
pack of the new weight, bf16 vals and uint8 idx.

What differs: the reference groups along the last axis of the
transposed master; here the master keeps its (K, F) layout, the groups
run along K (axis 0), and vals/idx come out as (K*n/m, F), the layout
``nm_spmm`` reads.  The function is the reference's applied to ``w.T``.
This wrapper only launches: it checks device, dtype, shape and
contiguity and raises on anything else; ``kernels.ops.fused_update``
sends CPU tensors to ``kernels.ref.ref_fused_update`` instead.
``launches`` counts the launches made here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
GROUP_SIZES = (2, 4, 8, 16)   # the m the kernel is instantiated for

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("fused_update")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_update_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                            f, f, f, f, p]
        lib.fused_update_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                 lr: float, mu: float, wd: float, lam: float, n: int,
                 m: int):
    """Launch the CUDA kernel on (K, F) fp32 ``w``, ``g``, ``v``; returns
    (w', v', vals (K*n/m, F) bf16, idx (K*n/m, F) uint8).  The scalars
    are passed as fp32."""
    global launches
    for name, t in (("w", w), ("g", g), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"fused_update: {name} is on {t.device}, not CUDA")
        if t.device != w.device:
            raise ValueError(f"fused_update: {name} is on {t.device}, w on "
                             f"{w.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fused_update: {name} must be float32, got "
                             f"{t.dtype}")
        if t.shape != w.shape or t.ndim != 2:
            raise ValueError(f"fused_update: {name} must be 2-D of w's shape "
                             f"{tuple(w.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_update: {name} must be contiguous")
    if m not in GROUP_SIZES or not 0 < n <= m:
        raise ValueError(f"fused_update: unsupported {n}:{m} (m in "
                         f"{GROUP_SIZES})")
    k, f = w.shape
    if k % m or k == 0 or f == 0:
        raise ValueError(f"fused_update: K={k} is not a positive multiple "
                         f"of m={m}, or F={f} is empty")
    lib = _library()
    kc = k // m * n
    w_out = torch.empty_like(w)
    v_out = torch.empty_like(v)
    vals = torch.empty((kc, f), dtype=torch.bfloat16, device=w.device)
    idx = torch.empty((kc, f), dtype=torch.uint8, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    with torch.cuda.device(w.device):
        err = lib.fused_update_launch(
            w.data_ptr(), g.data_ptr(), v.data_ptr(), w_out.data_ptr(),
            v_out.data_ptr(), vals.data_ptr(), idx.data_ptr(), k, f, n, m,
            float(lr), float(mu), float(wd), float(lam), stream)
    if err != 0:
        raise RuntimeError(f"fused_update: kernel launch failed, CUDA error "
                           f"{err}")
    launches += 1
    return w_out, v_out, vals, idx
