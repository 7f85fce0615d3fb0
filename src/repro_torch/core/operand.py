"""SparseOperand — the N:M weight-consumption seam, forward only.

Counterpart of ``src/repro/core/operand.py``: ``DenseOp``, ``MaskedOp``,
``PackedOp``, ``as_operand``, ``nm_apply`` and ``_packed_serve``.  Every
weight matmul of the model calls ``nm_apply(op, x)``.

What differs:
  * operands are plain classes, not registered pytrees;
  * serving is forward only, so there are no custom backward rules
    (``masked_linear`` is a plain matmul of the FF-masked weight) and no
    ``PregenOp``/``SharedOp`` (training and shared-pattern serving are
    later slices);
  * there is no ``backend``/``backend_scope``: the device of the packed
    pair picks the kernel (``kernels.ops.nm_spmm``), and the port's
    parameters are per layer, so a packed pair is always 2-D (K·N/M, F).
"""

from __future__ import annotations

import torch

from repro_torch.core import bdwp
from repro_torch.core.sparsity import DENSE, SparsityConfig, sparsify
from repro_torch.kernels import ops


class SparseOperand:
    """Base class of the operand types."""

    cfg = None


class DenseOp(SparseOperand):
    """A dense weight: plain matmul."""

    def __init__(self, w: torch.Tensor):
        self.w = w


class MaskedOp(SparseOperand):
    """In-op masking: the FF mask is re-derived from ``w`` on every call."""

    def __init__(self, w: torch.Tensor, cfg: SparsityConfig):
        self.w = w
        self.cfg = cfg


class PackedOp(SparseOperand):
    """Element-packed serving weight: vals (K·N/M, F) surviving values and
    idx the uint8 in-group offsets — same shape as vals with
    ``idx_bits=8``, or the u4 plane (ceil(K·N/M / 2), F) with
    ``idx_bits=4``."""

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor,
                 cfg: SparsityConfig, idx_bits: int = 8):
        if idx_bits not in (4, 8):
            raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
        self.vals = vals
        self.idx = idx
        self.cfg = cfg
        self.idx_bits = idx_bits


def as_operand(leaf, name: str, cfg: SparsityConfig) -> SparseOperand:
    """Operands pass through; a plain weight tensor becomes a MaskedOp
    with its per-parameter config (``bdwp.pick_cfg``)."""
    if isinstance(leaf, SparseOperand):
        return leaf
    if isinstance(leaf, torch.Tensor):
        return MaskedOp(leaf, bdwp.pick_cfg(name, tuple(leaf.shape), cfg))
    raise TypeError(f"unrecognized operand for {name}: {type(leaf).__name__}")


def masked_linear(x: torch.Tensor, w: torch.Tensor,
                  cfg: SparsityConfig) -> torch.Tensor:
    """y = x @ w_FF, the FF weight N:M-masked along K when cfg prunes FF
    weights (the reference's forward; its backward is not ported).

    Products and sums in fp32, rounded once to x's dtype, as the
    reference's bf16 dot computes; PyTorch's own CPU bf16 matmul rounds
    differently now and then."""
    if cfg.prunes_ff_weights():
        w = sparsify(w, cfg, axis=0)
    y = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    return y.to(x.dtype)


def _packed_serve(x: torch.Tensor, op: PackedOp) -> torch.Tensor:
    """Element-packed serving matmul through ``kernels.ops.nm_spmm``:
    fp32 out, cast back to the activation dtype."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = ops.nm_spmm(x2, op.vals, op.idx, op.cfg.n, op.cfg.m, op.idx_bits)
    return y.reshape(*x.shape[:-1], op.vals.shape[-1]).to(x.dtype)


def nm_apply(op: SparseOperand, x: torch.Tensor) -> torch.Tensor:
    """Apply one operand to activations x (..., K) -> (..., F)."""
    if isinstance(op, DenseOp):
        op = MaskedOp(op.w, DENSE)
    if isinstance(op, MaskedOp):
        return masked_linear(x, op.w, op.cfg)
    if isinstance(op, PackedOp):
        return _packed_serve(x, op)
    raise TypeError(f"nm_apply: not a SparseOperand: {type(op).__name__}")
