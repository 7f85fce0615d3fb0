"""SparseOperand — the N:M weight-consumption seam.

Counterpart of ``src/repro/core/operand.py``: ``DenseOp``, ``MaskedOp``,
``PregenOp``, ``PackedOp``, ``SharedOp``, ``as_operand``, ``nm_apply``,
``_packed_serve``, ``_shared_serve`` and the custom-gradient cores
``masked_linear``, ``pregen_linear``, ``packed_pregen_linear`` and
``packed_pregen_linear_t`` (transposable masks), and their conv views
``masked_conv`` and ``pregen_conv`` (NHWC activations, HWIO weights)
with ``_pregen_ff_dense``.  Every weight matmul or conv of
the model calls ``nm_apply(op, x)``.  The cores carry the paper's
training rules (Alg. 1 / Fig. 11c) as ``torch.autograd.Function``s:

  FF : y  = x @ w_FF          (the sparse operand)
  BP : dx = g @ w_BP^T        (``bp``, or the re-derived BP mask)
  WU : dW = x^T @ g           (dense, straight-through, fp32-accumulated,
                               cast to the weight's dtype; for a
                               PregenOp it is ``bp``'s gradient)

What differs:
  * operands are plain classes, not registered pytrees;
  * there is no ``backend``/``backend_scope``: a packed pair always goes
    through ``kernels.ops.nm_spmm`` (a ``SharedOp`` through
    ``kernels.ops.nm_spmm_shared``), whose input's device picks the
    kernel or the plain version; the port's parameters are per layer,
    so a weight's rank says what it is: a packed pair is 2-D (K·N/M, F),
    or an (E, K·N/M, F) expert stack, which ``nm_spmm`` takes in one
    launch where the reference vmaps its kernel over the experts
    (``_spmm_stacked``), and needs no ``stacked`` flag;
  * ``padding`` is "SAME" or "VALID" (the reference also takes explicit
    pads; no caller passes them).  SAME is XLA's: an odd total goes to
    the high side (``same_padding``), which torch's symmetric
    ``padding=`` cannot express, so such an input is padded first.
Every product here is fp32-accumulated and rounded once (``matmul_once``;
a conv is cuDNN's on the card and an fp32 conv rounded once on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bdwp
from repro_torch.core.sparsity import (DENSE, SparsityConfig, nm_unpack_n,
                                       sparsify, unpack_idx_u4)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decompress_nm


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


class PregenOp(SparseOperand):
    """Pre-generated WU-time operands (``optim.sgd``, paper Fig. 11c).

    ``bp`` (K, F), or (H, W, I, O) for a conv, is the BP operand; its
    gradient carries the dense straight-through WU gradient.  Exactly one
    FF operand: ``ff`` of bp's shape in the dense layout, or the
    SORE-packed pair along the contraction axis, ``vals`` (K·N/M, F) or
    (H, W, I·N/M, O) and ``idx`` (uint8 offsets of the same shape,
    ``idx_bits=8``).  ``mask`` is the stored SR-STE decay mask.

    With a transposable config (one mask N:M along both axes) ``bp``
    alone is also valid: the same array is the FF operand."""

    def __init__(self, *, bp, ff=None, vals=None, idx=None, mask=None,
                 cfg: SparsityConfig | None = None, idx_bits: int = 8):
        transposable = cfg is not None and cfg.transposable
        if ff is not None and vals is not None:
            raise ValueError("PregenOp needs at most one of ff | (vals, idx)")
        if ff is None and vals is None and not transposable:
            raise ValueError("PregenOp needs exactly one of ff | (vals, idx)"
                             " (bp-only operands need a transposable cfg)")
        if (vals is None) != (idx is None):
            raise ValueError("PregenOp packed form needs both vals and idx")
        if idx_bits not in (4, 8):
            raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
        self.bp = bp
        self.ff = ff
        self.vals = vals
        self.idx = idx
        self.mask = mask
        self.cfg = cfg
        self.idx_bits = idx_bits

    @property
    def is_packed(self) -> bool:
        return self.vals is not None

    @property
    def is_transposable(self) -> bool:
        return self.cfg is not None and self.cfg.transposable


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


class SharedOp(SparseOperand):
    """Shared-pattern reduced-K serving weight (``bdwp.pack_tree_shared``):
    vals (K·N/M, F) the pre-gathered surviving rows of w, idx (K·N/M,)
    int32 their absolute K rows; the forward gathers those activation
    columns and contracts an M/N-times-shorter K.  ``k``: the K the rows
    index (the weight's, or on a rank the K block a row-parallel block's
    rebased rows index; ``sharding.tp``), None where unknown."""

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor,
                 k: Optional[int] = None):
        self.vals = vals
        self.idx = idx
        self.k = k


def as_operand(leaf, name: str, cfg: SparsityConfig) -> SparseOperand:
    """Operands pass through; a flat packed dict ``{"vals", "idx"}``
    becomes a PackedOp (idx of vals' rank, byte-wide) or a SharedOp (one
    K row per packed row); a plain weight tensor becomes a MaskedOp with
    its per-parameter config (``bdwp.pick_cfg``)."""
    if isinstance(leaf, SparseOperand):
        return leaf
    if isinstance(leaf, dict) and "vals" in leaf and "idx" in leaf:
        if leaf["idx"].ndim == leaf["vals"].ndim:
            return PackedOp(leaf["vals"], leaf["idx"], cfg, idx_bits=8)
        return SharedOp(leaf["vals"], leaf["idx"])
    if isinstance(leaf, torch.Tensor):
        return MaskedOp(leaf, bdwp.pick_cfg(name, tuple(leaf.shape), cfg))
    raise TypeError(f"unrecognized operand for {name}: {type(leaf).__name__}")


def matmul_once(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """a @ b of 2-D operands, or of 3-D stacks (one product per leading
    index): products and sums in fp32, rounded once to ``out_dtype``, as
    the reference's dot with fp32 accumulation computes.  On the card one
    cuBLAS product of the 16-bit operands with fp32 output; on the CPU an
    fp32 matmul (PyTorch's own CPU bf16 matmul rounds differently now and
    then)."""
    mm = torch.bmm if a.ndim == 3 else torch.mm
    if a.is_cuda and a.dtype != torch.float32:
        y = mm(a, b, out_dtype=torch.float32)
    else:
        y = mm(a.to(torch.float32), b.to(torch.float32))
    return y.to(out_dtype)


def _rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x as the 2-D (tokens, K) operand of a (K, F) weight, or as the
    (E, tokens, K) stack of an (E, K, F) one (x (E, ..., K))."""
    stack = w.ndim - 2
    return x.reshape(*x.shape[:stack], -1, x.shape[-1])


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, F) -> (..., F) in x's dtype; a stacked w
    (E, K, F) multiplies each x[e] (E, ..., K) by its w[e]."""
    y = matmul_once(_rows(x, w), w.to(x.dtype), x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _weight_grad(x: torch.Tensor, gc: torch.Tensor, dtype,
                 stack: int = 0) -> torch.Tensor:
    """WU: dW = x^T @ g over all tokens (per expert of a stack),
    fp32-accumulated, cast to dtype."""
    x2 = x.reshape(*x.shape[:stack], -1, x.shape[-1])
    g2 = gc.reshape(*gc.shape[:stack], -1, gc.shape[-1])
    return matmul_once(x2.transpose(-1, -2), g2, dtype)


def _ff_weights(w: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """FF-pruned weights: N:M groups along the contraction axis (per
    expert of a stack)."""
    if not cfg.prunes_ff_weights():
        return w
    return sparsify(w, cfg, axis=w.ndim - 2, share_axis=w.ndim - 1)


def _bp_weights(w: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """BP-pruned weights: N:M groups along the output axis."""
    if not cfg.prunes_bp_weights():
        return w
    return sparsify(w, cfg, axis=w.ndim - 1, share_axis=w.ndim - 2)


class _MaskedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, w)
        return _linear(x, _ff_weights(w, cfg))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        # BP/WU run in the compute dtype: the cotangent is cast down
        gc = g.to(x.dtype)
        if cfg.prunes_bp_grads():   # SDGP prunes the output gradients
            dx = _linear(sparsify(gc, cfg, axis=-1), w.transpose(-1, -2))
        else:
            dx = _linear(gc, _bp_weights(w, cfg).transpose(-1, -2))
        return dx, _weight_grad(x, gc, w.dtype, w.ndim - 2), None


class _PregenLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ff, bp):
        ctx.save_for_backward(x, bp)
        return _linear(x, ff)

    @staticmethod
    def backward(ctx, g):
        x, bp = ctx.saved_tensors
        gc = g.to(x.dtype)
        return (_linear(gc, bp.transpose(-1, -2)), None,
                _weight_grad(x, gc, bp.dtype, bp.ndim - 2))


class _PackedPregenLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vals, idx, bp, n, m, idx_bits, transposable):
        ctx.nm = (n, m, idx_bits, transposable)
        ctx.save_for_backward(x, bp, vals, idx)
        y = ops.nm_spmm(_rows(x, vals).contiguous(), vals, idx, n, m,
                        idx_bits)
        return y.reshape(*x.shape[:-1], vals.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, bp, vals, idx = ctx.saved_tensors
        n, m, idx_bits, transposable = ctx.nm
        gc = g.to(x.dtype)
        # a transposable pair is N:M along F too: dgrad reads it, not bp
        w_bp = (decompress_nm(vals, idx, n, m, axis=-2, idx_bits=idx_bits)
                if transposable else bp)
        return (_linear(gc, w_bp.transpose(-1, -2)), None, None,
                _weight_grad(x, gc, bp.dtype, bp.ndim - 2), None, None,
                None, None)


def masked_linear(x: torch.Tensor, w: torch.Tensor,
                  cfg: SparsityConfig) -> torch.Tensor:
    """y = x @ w with cfg.method's N:M training semantics: FF on the
    K-masked weight, BP on the output-masked weight (or, for SDGP, on
    the N:M-pruned output gradient), dense WU."""
    return _MaskedLinear.apply(x, w, cfg)


def pregen_linear(x: torch.Tensor, ff: torch.Tensor,
                  bp: torch.Tensor) -> torch.Tensor:
    """y = x @ ff with BP on ``bp`` and the dense WU gradient on ``bp``'s
    gradient; ``ff`` gets none."""
    return _PregenLinear.apply(x, ff, bp)


def packed_pregen_linear(x: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, bp: torch.Tensor, n: int, m: int,
                         idx_bits: int = 8) -> torch.Tensor:
    """``pregen_linear`` with the FF operand SORE-packed: the forward
    reads (vals, idx) through ``kernels.ops.nm_spmm`` and never builds the
    dense FF weight; BP and WU as ``pregen_linear``; ``vals`` and
    ``idx`` get no gradient."""
    return _PackedPregenLinear.apply(x, vals, idx, bp, n, m, idx_bits, False)


def packed_pregen_linear_t(x: torch.Tensor, vals: torch.Tensor,
                           idx: torch.Tensor, bp: torch.Tensor, n: int,
                           m: int, idx_bits: int = 8) -> torch.Tensor:
    """``packed_pregen_linear`` for a transposable mask (arXiv
    2102.08124): the one mask is N:M along both axes, so the packed pair
    serves FF and BP.  The forward is ``packed_pregen_linear``'s; dgrad
    contracts g with the decompressed pair (``kernels.ref.decompress_nm``,
    exact: bitwise ``bp``) instead of reading ``bp``, which only carries
    the dense straight-through WU gradient."""
    return _PackedPregenLinear.apply(x, vals, idx, bp, n, m, idx_bits, True)


# ---------------------------------------------------------------------------
# Conv view: x (N, H, W, C) NHWC, w (KH, KW, I, O) HWIO -> (N, H', W', O)
# ---------------------------------------------------------------------------

_CONV_IN_AXIS = 2   # HWIO: input-channel axis (FF grouping, Fig. 5a)
_CONV_OUT_AXIS = 3  # HWIO: output-channel axis (BP grouping, Fig. 5b)


def same_padding(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding of one spatial axis, (low, high): the output
    has ceil(size / stride) positions, and of an odd total the extra unit
    goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_pads(x_shape, w_shape, stride: int, padding: str) -> tuple:
    """((low, high) of H, (low, high) of W) for an NHWC input and an HWIO
    weight (or a window of that size)."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tuple(same_padding(x_shape[1 + a], w_shape[a], stride)
                     for a in range(2))
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _conv_input(x: torch.Tensor, pads):
    """(x as cuDNN's channels_last NCHW view, torch's symmetric padding):
    a padding whose two sides differ is applied to x first."""
    (hl, hh), (wl, wh) = pads
    if hl != hh or wl != wh:
        x = F.pad(x, (0, 0, wl, wh, hl, hh))
        hl = wl = 0
    xc = x.permute(0, 3, 1, 2)
    return (xc if x.is_cuda else xc.to(torch.float32)), (hl, wl)


def _conv_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """An HWIO weight as the OIHW view conv2d takes, in ``dtype`` (fp32 on
    the CPU)."""
    wc = w.to(dtype).permute(3, 2, 0, 1)
    return wc if w.is_cuda else wc.to(torch.float32)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """NHWC x HWIO conv with w cast to x's dtype, output in x's dtype."""
    xc, pad = _conv_input(x, pads)
    y = F.conv2d(xc, _conv_weight(w, x.dtype), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _conv_grads(x, w, g, stride: int, pads, need_dx: bool, need_dw: bool):
    """(dx, dw) of ``_conv(x, w)`` for the output gradient g, both in x's
    dtype (None where not needed); dw is contiguous HWIO."""
    xc, pad = _conv_input(x, pads)
    gc = g.to(x.dtype).permute(0, 3, 1, 2)
    if not x.is_cuda:
        gc = gc.to(torch.float32)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        gc, xc, _conv_weight(w, x.dtype), None, [stride, stride], list(pad),
        [1, 1], False, [0, 0], 1, [need_dx, need_dw, False])
    if dx is not None:
        (hl, _), (wl, _) = pads
        dx = dx.permute(0, 2, 3, 1)
        if tuple(dx.shape) != tuple(x.shape):    # padded first: crop
            dx = dx[:, hl:hl + x.shape[1], wl:wl + x.shape[2]]
        dx = dx.to(x.dtype)
    if dw is not None:
        dw = dw.permute(2, 3, 1, 0).to(x.dtype).contiguous()
    return dx, dw


class _MaskedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, cfg, stride, pads):
        ctx.cfg, ctx.stride, ctx.pads = cfg, stride, pads
        ctx.save_for_backward(x, w)
        w_ff = sparsify(w, cfg, axis=_CONV_IN_AXIS,
                        share_axis=_CONV_OUT_AXIS) \
            if cfg.prunes_ff_weights() else w
        return _conv(x, w_ff, stride, pads)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg, stride, pads = ctx.cfg, ctx.stride, ctx.pads
        need_dx = ctx.needs_input_grad[0]
        if cfg.prunes_bp_grads():   # SDGP: N:M across output channels
            dx, _ = _conv_grads(x, w, sparsify(g, cfg, axis=-1), stride,
                                pads, need_dx, False)
            _, dw = _conv_grads(x, w, g, stride, pads, False, True)
        else:   # the wgrad does not read the weights: one call for both
            w_bp = sparsify(w, cfg, axis=_CONV_OUT_AXIS,
                            share_axis=_CONV_IN_AXIS) \
                if cfg.prunes_bp_weights() else w
            dx, dw = _conv_grads(x, w_bp, g, stride, pads, need_dx, True)
        return dx, dw.to(w.dtype), None, None, None


class _PregenConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ff, bp, stride, pads):
        ctx.stride, ctx.pads = stride, pads
        ctx.save_for_backward(x, bp)
        return _conv(x, ff, stride, pads)

    @staticmethod
    def backward(ctx, g):
        x, bp = ctx.saved_tensors
        dx, dw = _conv_grads(x, bp, g, ctx.stride, ctx.pads,
                             ctx.needs_input_grad[0], True)
        return dx, None, dw.to(bp.dtype), None, None


def masked_conv(x: torch.Tensor, w: torch.Tensor, cfg: SparsityConfig,
                stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Conv view of ``masked_linear``: FF on w N:M-masked along its input
    channels, dgrad on w masked along its output channels (or, for SDGP,
    on the N:M-pruned output gradient), dense straight-through wgrad."""
    return _MaskedConv.apply(x, w, cfg, stride,
                             conv_pads(x.shape, w.shape, stride, padding))


def pregen_conv(x: torch.Tensor, ff: torch.Tensor, bp: torch.Tensor,
                stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Conv view of ``pregen_linear``: FF convolves ``ff``, dgrad
    convolves ``bp``, and the dense straight-through wgrad is ``bp``'s
    gradient; ``ff`` gets none."""
    return _PregenConv.apply(x, ff, bp, stride,
                             conv_pads(x.shape, bp.shape, stride, padding))


def _packed_serve(x: torch.Tensor, op: PackedOp) -> torch.Tensor:
    """Element-packed serving matmul through ``kernels.ops.nm_spmm``:
    fp32 out, cast back to the activation dtype."""
    return nm_apply_f32(op, x).to(x.dtype)


def nm_apply_f32(op: SparseOperand, x: torch.Tensor) -> torch.Tensor:
    """``nm_apply`` of a 2-D serving weight (plain, masked, a
    ``PackedOp`` or a ``SharedOp``) without its last step, the rounding
    of the fp32 product to x's dtype: the partial product that a
    row-parallel projection sums over ranks first (``sharding.tp``).
    No autograd."""
    if isinstance(op, DenseOp):
        op = MaskedOp(op.w, DENSE)
    if isinstance(op, MaskedOp):
        w = _ff_weights(op.w, op.cfg)
        y = matmul_once(_rows(x, w), w.to(x.dtype), torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    if isinstance(op, PackedOp):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = ops.nm_spmm(x2, op.vals, op.idx, op.cfg.n, op.cfg.m,
                        op.idx_bits)
        return y.reshape(*x.shape[:-1], op.vals.shape[-1])
    if isinstance(op, SharedOp):   # one output tile, TF = F
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = ops.nm_spmm_shared(x2, op.vals[None], op.idx[None])
        return y.reshape(*x.shape[:-1], op.vals.shape[-1])
    raise TypeError(f"nm_apply_f32: not a serving operand: "
                    f"{type(op).__name__}")


def _shared_serve(x: torch.Tensor, op: SharedOp) -> torch.Tensor:
    """Shared-pattern serving matmul through ``kernels.ops.nm_spmm_shared``
    (one output tile, TF = F): fp32 out, rounded once to the activation
    dtype."""
    return nm_apply_f32(op, x).to(x.dtype)


def _pregen_ff_dense(op: PregenOp) -> torch.Tensor:
    """The dense-layout FF operand of a PregenOp: ``ff``, the packed
    pair scattered back along the contraction axis (exact), or, for a
    transposable bp-only operand, ``bp`` itself."""
    if op.ff is not None:
        return op.ff
    if not op.is_packed:
        return op.bp
    idx = op.idx
    if op.idx_bits == 4:
        idx = unpack_idx_u4(idx, op.vals.shape[-2], axis=-2)
    return nm_unpack_n(op.vals, idx, op.cfg.n, op.cfg.m, axis=-2)


def nm_apply(op: SparseOperand, x: torch.Tensor, *, stride: int = 1,
             padding: str = "SAME") -> torch.Tensor:
    """Apply one operand to activations: x (..., K) -> (..., F) for a
    2-D weight; an (E, K, F) stack (MoE experts, the reference's
    ``stacked=True``) on x (E, ..., K), each expert's rows by its own
    weight, N:M groups within the expert (a packed stack in one
    ``nm_spmm`` launch); the conv view (NHWC x HWIO, ``stride``,
    ``padding``) for a rank-4 one."""
    if isinstance(op, DenseOp):
        op = MaskedOp(op.w, DENSE)
    if isinstance(op, MaskedOp):
        if op.w.ndim == 4:
            return masked_conv(x, op.w, op.cfg, stride, padding)
        return masked_linear(x, op.w, op.cfg)
    if isinstance(op, PregenOp):
        if op.bp.ndim == 4:
            return pregen_conv(x, _pregen_ff_dense(op), op.bp, stride,
                               padding)
        if op.is_packed:
            fn = (packed_pregen_linear_t if op.is_transposable
                  else packed_pregen_linear)
            return fn(x, op.vals, op.idx, op.bp, op.cfg.n, op.cfg.m,
                      op.idx_bits)
        return pregen_linear(x, _pregen_ff_dense(op), op.bp)
    if isinstance(op, PackedOp):
        return _packed_serve(x, op)
    if isinstance(op, SharedOp):
        return _shared_serve(x, op)
    raise TypeError(f"nm_apply: not a SparseOperand: {type(op).__name__}")
