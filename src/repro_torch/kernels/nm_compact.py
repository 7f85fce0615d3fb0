"""Wrapper of the Hopper ``nm_compact`` kernel (``csrc/nm_compact.cu``).

Counterpart of ``src/repro/kernels/nm_compact.py:nm_compact_pallas``
(SORE): pack a (R, K) operand N:M along its last axis into the n largest
|x| of each m-group, values in x's dtype (R, K*n/m) and their in-group
offsets as uint8 (R, Kc) or the u4 plane (R, ceil(Kc/2)), survivors in
ascending offset, the first position winning a tie.  The function is the
plain version ``kernels.ref.ref_nm_compact``, bit for bit.

What differs: x and both outputs may be strided views (any element
strides), so a (K, F) weight is packed along K through its transposed
view straight into the (Kc, F) layout ``nm_spmm`` reads (``out=``); any
Kc is taken, an odd one with u4 indices included (the reference's
``ops.nm_compact`` sends an odd u4 tile to its oracle), so the port has
no shape fallback.  This wrapper only launches: it checks device, dtype,
shape and m and raises on anything else; ``kernels.ops.nm_compact``
sends CPU tensors to the plain version instead.

The kernel has two hand-written variants with the same bits: "vector"
(a thread packs one 16-byte chunk of columns of one group with 16-byte
loads and stores, a persistent grid) where ``vector_ok`` holds: n <= 4,
the R axis has unit stride in x, vals and idx (the element pack's
transposed weight views), R is a whole number of 16-byte chunks of x
and every base pointer and K stride is a multiple of 16 bytes; and
"scalar" (one thread per group, any strides) for the rest: score rows,
ragged or misaligned views, n > 4.  ``variant="auto"`` picks the vector
one where it may run; asking for "vector" where it may not raises.
``launches`` counts the launches made here and nowhere else,
``variant_launches`` the same launches per variant.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
VARIANTS = ("vector", "scalar")
variant_launches = dict.fromkeys(VARIANTS, 0)
GROUP_SIZES = (2, 4, 8, 16)   # the m the kernel is instantiated for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_MAX_N = 4              # the n the vector variant is built for

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("nm_compact")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.nm_compact_launch.argtypes = [p, i, i64, i64, p, i64, i64, p,
                                          i64, i64, i64, i, i, i, i, i, p]
        lib.nm_compact_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_out(name, t, shape, dtype, like):
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"nm_compact: {name} is on {t.device}, x on "
                         f"{like.device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"nm_compact: {name} must be {dtype} of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")


def vector_ok(rows: int, itemsize: int, n: int, x, vals, idx) -> bool:
    """May the vector variant take an n:m call with ``rows`` = R and x of
    ``itemsize`` bytes?  ``x``, ``vals`` and ``idx`` are each (data
    pointer, R stride, K stride), strides in elements."""
    if n > VECTOR_MAX_N or (rows * itemsize) % 16:
        return False
    for (ptr, s_r, s_k), size in ((x, itemsize), (vals, itemsize),
                                  (idx, 1)):
        if s_r != 1 or ptr % 16 or (s_k * size) % 16:
            return False
    return True


def pick_variant(variant: str, x: torch.Tensor, vals: torch.Tensor,
                 idx: torch.Tensor, n: int) -> str:
    """The variant an n:m launch on (x, vals, idx) takes: "auto" is
    "vector" where ``vector_ok`` holds, else "scalar"; "vector" where it
    does not hold raises."""
    if variant not in ("auto", *VARIANTS):
        raise ValueError(f"nm_compact: variant must be 'auto' or one of "
                         f"{VARIANTS}, got {variant!r}")
    ok = vector_ok(x.shape[0], x.element_size(), n,
                   *((t.data_ptr(), t.stride(0), t.stride(1))
                     for t in (x, vals, idx)))
    if variant == "auto":
        return "vector" if ok else "scalar"
    if variant == "vector" and not ok:
        raise ValueError(
            f"nm_compact: the vector variant needs n <= {VECTOR_MAX_N}, unit "
            "R strides, R a whole number of 16-byte chunks and 16-byte "
            f"aligned pointers and K strides (n={n}, x {tuple(x.shape)} "
            f"strides {x.stride()}, vals strides {vals.stride()}, idx "
            f"strides {idx.stride()})")
    return variant


def nm_compact(x: torch.Tensor, n: int, m: int, idx_bits: int = 8, *,
               out=None, variant: str = "auto"):
    """Launch the CUDA kernel on the (R, K) CUDA tensor ``x`` (fp32 or
    bf16, any strides); returns (vals, idx), written into ``out`` =
    (vals, idx) views when given, else into new contiguous tensors.
    ``variant``: "auto", "vector" or "scalar"."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"nm_compact: x is on {x.device}, not CUDA")
    if x.dtype not in DTYPES:
        raise ValueError(f"nm_compact: x must be one of {tuple(DTYPES)}, "
                         f"got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"nm_compact: x must be 2-D, got {tuple(x.shape)}")
    if idx_bits not in (4, 8):
        raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
    if m not in GROUP_SIZES or not 0 < n <= m:
        raise ValueError(f"nm_compact: unsupported {n}:{m} (m in "
                         f"{GROUP_SIZES})")
    r, k = x.shape
    if r == 0 or k == 0 or k % m:
        raise ValueError(f"nm_compact: ({r}, {k}) is empty or K is not a "
                         f"multiple of m={m}")
    kc = k // m * n
    kci = (kc + 1) // 2 if idx_bits == 4 else kc
    if out is None:
        vals = torch.empty((r, kc), dtype=x.dtype, device=x.device)
        idx = torch.empty((r, kci), dtype=torch.uint8, device=x.device)
    else:
        vals, idx = out
        _check_out("vals", vals, (r, kc), x.dtype, x)
        _check_out("idx", idx, (r, kci), torch.uint8, x)
    kind = pick_variant(variant, x, vals, idx, n)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.nm_compact_launch(
            x.data_ptr(), DTYPES[x.dtype], x.stride(0), x.stride(1),
            vals.data_ptr(), vals.stride(0), vals.stride(1), idx.data_ptr(),
            idx.stride(0), idx.stride(1), r, k, n, m, idx_bits,
            int(kind == "vector"), stream)
    if err != 0:
        raise RuntimeError(f"nm_compact: kernel launch failed, CUDA error "
                           f"{err}")
    launches += 1
    variant_launches[kind] += 1
    return vals, idx
