"""Plain PyTorch versions of the port's kernels.

Counterpart of ``src/repro/kernels/ref.py`` (``ref_nm_compact``,
``ref_nm_spmm``, ``ref_nm_spmm_shared``, ``ref_fused_update``), of the
jnp paths ``_jnp_grad_compress`` and
``_jnp_grad_decompress_mean`` in ``src/repro/kernels/ops.py``, and of
the select-based decompress in
``src/repro/kernels/nm_spmm_shared.py`` (``unpack_idx_nibbles``,
``decompress_nm``).  These define what the CUDA kernels must compute:
the CPU path runs them, and ``chip_smoke.py`` holds the kernels against
them on the card.  ``decompress_nm``, ``ref_nm_compact`` and
``ref_fused_update`` are bitwise equal to the reference's, and so are
``ref_grad_compress`` and ``ref_grad_decompress_mean``; ``ref_nm_spmm``
and ``ref_nm_spmm_shared`` are fp32 matmuls of the same exact bf16
products, so they differ from the reference only in summation order.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import sparsity as S


def unpack_idx_nibbles(idx: torch.Tensor, kc: int, axis: int) -> torch.Tensor:
    """Two-per-byte nibble expansion along ``axis`` (low nibble first),
    trimmed to ``kc`` entries."""
    axis = axis % idx.ndim
    pair = torch.stack([idx & 0x0F, idx >> 4], dim=axis + 1)
    shape = idx.shape[:axis] + (2 * idx.shape[axis],) + idx.shape[axis + 1:]
    return pair.reshape(shape).narrow(axis, 0, kc)


def decompress_nm(vals: torch.Tensor, idx: torch.Tensor, n: int, m: int,
                  axis: int = -1, idx_bits: int = 8) -> torch.Tensor:
    """(…, Kc, …) packed -> (…, K, …) dense along ``axis``, K = Kc*m/n.

    dense[g*m + s] = sum_j vals[g*n + j] * (idx[g*n + j] == s): an m-way
    select, no scatter.  With ``idx_bits=4`` ``idx`` is the u4 plane
    (ceil(Kc/2) bytes along ``axis``).
    """
    axis = axis % vals.ndim
    kc = vals.shape[axis]
    if kc % n:
        raise ValueError(f"packed axis {kc} not divisible by n={n}")
    if idx_bits == 4:
        idx = unpack_idx_nibbles(idx, kc, axis)
    elif idx_bits != 8:
        raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
    shape = vals.shape
    g = kc // n
    gshape = shape[:axis] + (g, n) + shape[axis + 1:]
    v = vals.reshape(gshape)
    i = idx.reshape(gshape)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    slots = []
    for s in range(m):
        hit = torch.where(i == s, v, zero)
        # summed from a zero start, one term at a time, as XLA's reduce
        # does (keeps the sign of a zero survivor identical)
        acc = torch.zeros_like(hit.select(axis + 1, 0))
        for j in range(n):
            acc = acc + hit.select(axis + 1, j)
        slots.append(acc)
    dense = torch.stack(slots, dim=axis + 1)
    return dense.reshape(shape[:axis] + (g * m,) + shape[axis + 1:])


def ref_nm_compact(x: torch.Tensor, n: int, m: int, idx_bits: int = 8):
    """SORE: pack x N:M along the last axis -> (vals in x's dtype (..., Kc),
    uint8 offsets (..., Kc), or with ``idx_bits=4`` the u4 plane
    (..., ceil(Kc/2)), low nibble first, an odd Kc's last high nibble 0).
    Bitwise the reference's ``ops.nm_compact`` (its oracle; its Pallas
    kernel turns a -0 survivor into +0, this keeps it)."""
    vals, idx = S.nm_pack(x, n, m, axis=-1)
    if idx_bits == 4:
        idx = S.pack_idx_u4(idx, axis=-1)
    elif idx_bits != 8:
        raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
    return vals, idx


def ref_nm_spmm(act: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                n: int, m: int, idx_bits: int = 8) -> torch.Tensor:
    """Element-mode N:M sparse matmul: act (B, K) @ unpack(vals (Kc, F),
    idx) -> (B, F) fp32, idx u8 (Kc, F) or the u4 plane (ceil(Kc/2), F);
    stacked, act (E, B, K) and vals/idx (E, ·, F) -> (E, B, F), each
    expert's rows by its own weight (the reference vmaps over E)."""
    w = decompress_nm(vals, idx, n, m, axis=-2, idx_bits=idx_bits)
    return torch.matmul(act.to(torch.float32),
                        w.to(act.dtype).to(torch.float32))


def ref_nm_spmm_shared(act: torch.Tensor, vals: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Shared-pattern reduced-K matmul: per output tile j, act[:, rows[j]]
    (B, Kc) @ vals[j] (Kc, TF) cast to act's dtype, in fp32 ->
    (B, nf*TF) fp32.  vals (nf, Kc, TF), rows (nf, Kc) integer K rows."""
    gathered = act[:, rows.long()].to(torch.float32)          # (B, nf, Kc)
    w = vals.to(act.dtype).to(torch.float32)
    out = torch.bmm(gathered.transpose(0, 1), w)              # (nf, B, TF)
    return out.transpose(0, 1).reshape(act.shape[0], -1)


def ref_fused_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor, *,
                     lr: float, mu: float, wd: float, lam: float, n: int,
                     m: int, axis: int = -1, bp_mode=None):
    """WUVE + SORE pre-generation (momentum SGD on the fp32 master).

    mask = N:M survivors of the pre-update ``w`` along ``axis``;
    g_eff = (f32(g) + wd*w) + lam*where(mask, 0, w); v' = mu*v + g_eff;
    w' = w - lr*v'; then w' packed along ``axis``.  Returns (w' fp32,
    v' fp32, vals bf16, idx uint8), the packed pair with ``axis``
    shortened to K*n/m.  With ``bp_mode`` (a 2-D ``w`` only) also the
    next step's BP operand and FF mask, as ``optim.sgd`` derives them
    from the pack: bp = bf16(where(nm_mask(w', other axis), w', 0)) for
    "bdwp", bf16(w') for "srste"; the FF mask is the pack's survivors,
    ``nm_unpack_n(ones, idx)``.  Every op rounds to fp32 on its own, in
    this order: the CUDA kernel is held to these bits.
    """
    if bp_mode not in (None, "bdwp", "srste"):
        raise ValueError(f"unknown bp_mode {bp_mode!r}")
    if bp_mode is not None and w.ndim != 2:
        raise ValueError(f"bp_mode needs a 2-D master, got {tuple(w.shape)}")
    mask = S.nm_mask(w, n, m, axis=axis)
    g_eff = g.to(torch.float32) + wd * w + lam * torch.where(mask, 0.0, w)
    new_v = mu * v + g_eff
    new_w = w - lr * new_v
    vals, idx = S.nm_pack(new_w, n, m, axis=axis)
    vals = vals.to(torch.bfloat16)
    if bp_mode is None:
        return new_w, new_v, vals, idx
    ff_mask = S.nm_unpack_n(torch.ones_like(vals, dtype=torch.bool), idx, n,
                            m, axis=axis)
    if bp_mode == "bdwp":
        bp = torch.where(S.nm_mask(new_w, n, m, axis=1 - axis % 2), new_w,
                         0.0)
    else:
        bp = new_w
    return new_w, new_v, vals, idx, bp.to(torch.bfloat16), ff_mask


@functools.lru_cache(maxsize=None)
def inv_pods(p: int) -> float:
    """float32(1/P), the factor the pod mean multiplies by (the compiled
    reference's ``.mean(axis=0)`` rounds this way, not as ``sum / P``)."""
    return (torch.tensor(1.0, dtype=torch.float32) / p).item()


def ref_grad_compress(g: torch.Tensor, err: torch.Tensor, n: int, m: int):
    """Error-feedback N:M compress along the last axis.

    t = f32(g) + err; the n largest |t| of each m-group survive (n
    rounds of first-maximum argmax), in ascending offset; vals = bf16(t)
    there; err' = t - f32(bf16(t)) at a survivor and t elsewhere, so
    decode(vals, idx) + err' == t.  Returns (vals bf16, idx uint8, each
    (..., K*n/m); err' fp32 (..., K)).  Bitwise the reference's
    ``ops.grad_compress`` (``_jnp_grad_compress``).
    """
    t = g.to(torch.float32) + err.to(torch.float32)
    k = t.shape[-1]
    if k % m:
        raise ValueError(f"last axis {k} not divisible by m={m}")
    gg = t.reshape(*t.shape[:-1], k // m, m)
    idx = S._topn_offsets(gg, n)
    vals = torch.gather(gg, -1, idx)
    survivor = torch.zeros(gg.shape, dtype=torch.bool, device=t.device)
    survivor.scatter_(-1, idx, True)
    rounded = gg.to(torch.bfloat16).to(torch.float32)
    new_err = torch.where(survivor, gg - rounded, gg).reshape(t.shape)
    kc = k // m * n
    return (vals.to(torch.bfloat16).reshape(*t.shape[:-1], kc),
            idx.to(torch.uint8).reshape(*t.shape[:-1], kc), new_err)


def ref_grad_decompress_mean(vals: torch.Tensor, idx: torch.Tensor, n: int,
                             m: int) -> torch.Tensor:
    """Pod mean of P packed payloads: vals bf16 / idx uint8 (P, Kc) ->
    (Kc*m/n,) fp32.  Each row is decoded (``decompress_nm``), the rows
    are summed in order p = 0..P-1 from +0, and the sum is multiplied
    by float32(1/P).  Bitwise the reference's ``ops.grad_decompress_mean``."""
    p = vals.shape[0]
    dense = decompress_nm(vals.to(torch.float32), idx, n, m, axis=-1)
    acc = torch.zeros_like(dense[0])
    for r in range(p):
        acc = acc + dense[r]
    return acc * inv_pods(p)
