"""Shared layer primitives on plain parameter dicts.

Counterpart of ``src/repro/models/layers.py``: ``dense_init`` (with an
optional zero bias), ``dense_apply`` (the bias added after ``nm_apply``,
in the output's dtype), ``rmsnorm_init``/``rmsnorm_apply``,
``layernorm_init``/``layernorm_apply``, ``embed_init``/``embed_apply``,
``rope_freqs``, ``apply_rope``, ``silu``, ``swiglu`` and ``gelu_tanh``
(the reference's ``jax.nn.gelu``), with the reference's arithmetic: the
norms in fp32 cast back to the input dtype,
RoPE over the two halves of head_dim (not interleaved pairs) in fp32,
SiLU and GELU as the reference computes them in bf16.

The reference's logical-axis vocabulary ("embed", "mlp", "heads",
"kv", "vocab", "expert"; "layer" for its stacked axis) is
``leaf_spec``: the spec of a leaf from its tree path, the tuple the
reference's ``*_init`` returns beside the leaf (``sharding.rules`` maps
the names onto mesh axes).  ``gathered`` is where a block's layers read
its params: a block kept in shards (``sharding.fsdp``) gathers its full
operands there.  ``column_apply`` / ``row_apply`` are ``dense_apply``
of a column- or row-parallel projection, and ``embed_apply`` the
vocab-parallel lookup, inside a ``sharding.tp.model_split``.

What differs: the spec trees are not returned by each ``*_init`` but
made from the leaf's path by ``leaf_spec`` (``transformer_lm.init_specs``,
``encdec.init_specs``), and init draws from an explicit
``torch.Generator`` on an explicit device — the same seed gives other
numbers than ``jax.random``, so parity tests load the reference's
weights through ``convert.params_from_jax``.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core import bdwp
from repro_torch.core import operand as O
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.sharding import tp


# the (K, F) weights of a dense layer, by (module, layer) name: the
# reference's ``axes=`` of each ``dense_init`` (attention.py, encdec.py,
# ssm.py, transformer_lm.py, moe.py)
_DENSE_AXES = {
    ("attn", "q_proj"): ("embed", "heads"),
    ("attn", "k_proj"): ("embed", "kv"),
    ("attn", "v_proj"): ("embed", "kv"),
    ("attn", "o_proj"): ("heads", "embed"),
    ("attn", "kv_down"): ("embed", None),
    ("attn", "k_up"): (None, "heads"),
    ("attn", "v_up"): (None, "heads"),
    ("ffn", "w_gate"): ("embed", "mlp"),
    ("ffn", "w_up"): ("embed", "mlp"),
    ("ffn", "w_down"): ("mlp", "embed"),
    ("ffn", "w_in"): ("embed", "mlp"),
    ("ffn", "w_out"): ("mlp", "embed"),
    ("ssm", "in_proj"): ("embed", "mlp"),
    ("ssm", "out_proj"): ("mlp", "embed"),
    ("moe", "router"): ("embed", None),
    ("", "lm_head"): ("embed", "vocab"),
}
_DENSE_AXES.update({("xattn", k): v for (m, k), v in _DENSE_AXES.items()
                    if m == "attn"})
# bare-array leaves: MoE expert stacks and shared-expert matrices, the
# SSD block's conv and per-head vectors, learned positions
_BARE_AXES = {
    ("moe", "w_gate"): ("expert", "embed", "mlp"),
    ("moe", "w_up"): ("expert", "embed", "mlp"),
    ("moe", "w_down"): ("expert", "mlp", "embed"),
    ("shared", "w_gate"): ("embed", "mlp"),
    ("shared", "w_up"): ("embed", "mlp"),
    ("shared", "w_down"): ("mlp", "embed"),
    ("ssm", "conv_w"): (None, "mlp"),
    ("ssm", "A_log"): (None,),
    ("ssm", "D"): (None,),
    ("ssm", "dt_bias"): (None,),
    ("", "pos_embed_dec"): (None, "embed"),
    ("", "pos_embed_enc"): (None, "embed"),
    ("embed", "embed_table"): ("vocab", "embed"),
}


def leaf_spec(path: tuple) -> tuple:
    """The logical axes of the leaf at ``path`` (dict keys, list indices
    left out), as the reference's init gives them for one layer (its
    stacked leaves add a leading "layer"): a dense layer's "w" and "b",
    a norm's scale and bias ("embed"; a head-wise q/k norm or MLA's
    ckv norm replicated; the SSD block's gated norm "mlp"), and the
    bare leaves of ``_BARE_AXES``.  Raises on a path it does not
    know."""
    key = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if key in ("norm_scale", "norm_bias"):
        if parent in ("q_norm", "k_norm", "ckv_norm"):
            return (None,)
        return ("mlp",) if parent == "ssm_norm" else ("embed",)
    if key in ("w", "b"):
        module = path[-3] if len(path) > 2 else ""
        axes = _DENSE_AXES.get((module, parent))
        if axes is not None:
            return axes if key == "w" else (axes[-1],)
    else:
        axes = _BARE_AXES.get((parent, key))
        if axes is not None:
            return axes
    raise KeyError(f"no logical axes for leaf {'/'.join(path)}")


def spec_tree(params):
    """``leaf_spec`` of every leaf of a param tree of dicts and lists."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return leaf_spec(path)

    return walk(params, ())


def gathered(p):
    """A block's params as its layers read them: ``p`` itself, or, for a
    block kept in shards (``sharding.fsdp.ShardedBlock``), its full
    operands gathered now.  Inside a rematerialized block this runs
    again in the recompute, so the full operands live for one block at
    a time."""
    gather = getattr(p, "gather", None)
    return p if gather is None else gather()


_TOKEN_SPLIT = [None]


@contextlib.contextmanager
def token_split(split):
    """Inside it the batch the model sees is one rank's contiguous row
    block of a batch split over ``split``'s ranks
    (``sharding.fsdp.TokenSplit``: ``parts``, ``index``, ``sum``,
    ``gather``): the MoE layers route and take their load-balance loss
    over the whole batch, as one SPMD program over it does.  A module
    global, not a context variable: the blocks' recompute runs in the
    autograd engine's threads."""
    prev = _TOKEN_SPLIT[0]
    _TOKEN_SPLIT[0] = split
    try:
        yield
    finally:
        _TOKEN_SPLIT[0] = prev


def current_token_split():
    """The ``token_split`` in force, or None."""
    return _TOKEN_SPLIT[0]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
               dtype=torch.float32, bias: bool = False):
    """{"w": (d_in, d_out)} ~ N(0, 1) * d_in**-0.5, drawn in fp32; with
    ``bias`` also {"b": (d_out,)} zeros (no draw)."""
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32) * d_in ** -0.5
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p, x: torch.Tensor, name: str, cfg: SparsityConfig,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ w through the SparseOperand seam (``core.operand.nm_apply``);
    ``p["w"]`` is a weight tensor (masked per ``bdwp.pick_cfg``) or an
    operand such as a ``PackedOp`` or a ``SharedOp``; a ``p`` without
    ``"w"`` is itself a flat packed ``{"vals", "idx"}`` dict (the
    shared-packed layout of older packers).  A bias ``p["b"]`` (never
    pruned or packed) is added after the product, in its dtype."""
    op = O.as_operand(p["w"] if "w" in p else p, name, cfg)
    y = O.nm_apply(op, x.to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def local_dims(w) -> tuple:
    """(K, F) of the rank's block of a weight: a tensor, a masked
    operand's, a ``PackedOp``'s (K from its Kc = K N/M packed rows) or a
    ``SharedOp``'s (the K its rows index)."""
    if isinstance(w, O.PackedOp):
        kc, f = w.vals.shape[-2:]
        return kc // w.cfg.n * w.cfg.m, f
    if isinstance(w, O.SharedOp):
        if w.k is None:
            raise ValueError("a SharedOp without its K (pack it with "
                             "core.bdwp.pack_tree_shared)")
        return w.k, w.vals.shape[-1]
    return tuple((w.w if isinstance(w, O.MaskedOp) else w).shape[-2:])


def _block_operand(w, name: str, cfg: SparsityConfig, whole: tuple):
    """The operand of a rank's block of a weight of shape ``whole``: a
    plain block is masked as the whole weight is (``bdwp.pick_cfg`` of
    the whole shape; a block may be too narrow to pass it alone)."""
    if isinstance(w, torch.Tensor):
        return O.MaskedOp(w, bdwp.pick_cfg(name, whole, cfg))
    return O.as_operand(w, name, cfg)


def column_apply(p, x: torch.Tensor, name: str, cfg: SparsityConfig,
                 full: int, want: tuple) -> torch.Tensor:
    """``dense_apply`` of a column-parallel projection whose whole output
    has ``full`` columns; inside a ``sharding.tp.model_split`` the
    columns ``want`` = (lo, hi) of the output, from the rank's block of
    the weight (and of its bias), gathered whole first where that block
    does not hold them (``tp.take``).  Outside it, ``dense_apply``."""
    split = tp.current()
    if split is None:
        return dense_apply(p, x, name, cfg)
    k, f = local_dims(p["w"])
    have = split.held(f, full)
    p = dict(p, w=_block_operand(p["w"], name, cfg, (k, full)))
    if "b" in p:
        p["b"] = tp.take(p["b"], split.held(p["b"].shape[-1], full), have,
                         full, split)
    return tp.take(dense_apply(p, x, name, cfg), have, want, full, split)


def row_apply(p, x: torch.Tensor, name: str, cfg: SparsityConfig,
              full: int, have: tuple) -> torch.Tensor:
    """``dense_apply`` of a row-parallel projection whose weight has
    ``full`` rows, on x holding the input columns ``have``; inside a
    ``sharding.tp.model_split`` the rank's row block of the weight takes
    its columns of x, and the fp32 partial products are summed over
    "model" (``tp.model_sum``) before the rounding to bf16 and the bias,
    which is whole.  Outside it, ``dense_apply``."""
    split = tp.current()
    if split is None:
        return dense_apply(p, x, name, cfg)
    k, f = local_dims(p["w"])
    rows = split.held(k, full)
    x = tp.take(x, have, rows, full, split)
    y = O.nm_apply_f32(_block_operand(p["w"], name, cfg, (full, f)),
                       x.to(torch.bfloat16))
    if rows != (0, full):
        y = tp.model_sum(y, split)
    y = y.to(torch.bfloat16)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(d: int, *, device, dtype=torch.float32):
    return {"norm_scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6,
                  out_dtype=None) -> torch.Tensor:
    """RMSNorm in fp32, cast to ``out_dtype`` (default: x's dtype)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["norm_scale"]
    return out.to(out_dtype or x.dtype)


def layernorm_init(d: int, *, device, dtype=torch.float32):
    return {"norm_scale": torch.ones((d,), dtype=dtype, device=device),
            "norm_bias": torch.zeros((d,), dtype=dtype, device=device)}


_BATCH_INVARIANT = [False]


@contextlib.contextmanager
def batch_invariant():
    """Inside it, on the card, the ops whose kernels the batch size picks
    (LayerNorm's row reductions, the attention's fp32 einsums, the head
    product) run on their operands padded along dim 0 to
    ``invariant_rows(B)`` rows, so that a row's bits are the same for
    every B of one bucket (1-8, 9-16, 17-32, ...).  cuBLAS picks another
    algorithm for a batched product of another batch count, and PyTorch's
    row reductions split a row over more threads when there are fewer
    rows.  The serving steps of the encoder-decoder's decoder run under
    it; the CPU path ignores it."""
    prev = _BATCH_INVARIANT[0]
    _BATCH_INVARIANT[0] = True
    try:
        yield
    finally:
        _BATCH_INVARIANT[0] = prev


def _padding_on(x: torch.Tensor) -> bool:
    return _BATCH_INVARIANT[0] and x.is_cuda


def invariant_rows(b: int) -> int:
    """The padded batch of ``batch_invariant``: the next power of two, at
    least 8."""
    return max(8, 1 << (b - 1).bit_length())


def batch_padded(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` with every x padded with zero rows along dim 0 to
    ``invariant_rows(B)`` and the result cut back to B rows, under
    ``batch_invariant`` on the card; else ``fn(*xs)``."""
    b = xs[0].shape[0]
    if not _padding_on(xs[0]):
        return fn(*xs)
    rows = invariant_rows(b)

    def pad(x):
        out = x.new_zeros((rows, *x.shape[1:]))
        out[:b] = x
        return out

    return fn(*(pad(x) for x in xs))[:b]


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 mean and population variance,
    ``(x - mu) * rsqrt(var + eps) * scale + bias``, cast back to x's
    dtype.  Batch-invariant under ``batch_invariant``."""
    return batch_padded(lambda t: _layernorm(p, t, eps), x)


def _layernorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["norm_scale"] \
        + p["norm_bias"]
    return out.to(x.dtype)


class _HeadProduct(torch.autograd.Function):
    """h (T, d) @ w (d, V) -> fp32 logits, w cast to h's dtype, products
    summed in fp32 (``operand.matmul_once``).  On the card the backward
    rounds the fp32 logit gradient to h's dtype before its two products,
    which keeps them on the tensor cores (as a TPU's default-precision
    fp32 dot rounds to bf16) and makes no fp32 copy of the table; on the
    CPU it stays fp32, as the reference's XLA CPU computes it.  Gradients
    come back in h's and w's dtypes."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return O.matmul_once(h, w.to(h.dtype), torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gc = g.to(h.dtype) if h.is_cuda else g
        return (O.matmul_once(gc, w.to(h.dtype).t(), h.dtype),
                O.matmul_once(h.t(), gc, w.dtype))


def head_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's ``jnp.matmul(h, w.astype(h.dtype),
    preferred_element_type=jnp.float32)`` of a 2-D h: fp32 logits;
    batch-invariant under ``batch_invariant``."""
    return batch_padded(lambda t: _HeadProduct.apply(t, w), h)


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device,
               dtype=torch.float32):
    t = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32) * d ** -0.5
    return {"embed_table": t.to(dtype)}


def embed_apply(p, tokens: torch.Tensor, compute_dtype=torch.bfloat16,
                rows=None) -> torch.Tensor:
    """The table's rows of ``tokens``; inside a ``sharding.tp.
    model_split``, where the rank may hold a row block of a table of
    ``rows`` rows, the vocab-parallel lookup (``tp.embed_lookup``)."""
    table = p["embed_table"]
    split = tp.current()
    if split is not None and split.held(table.shape[0], rows) != (0, rows):
        return tp.embed_lookup(table, tokens, split).to(compute_dtype)
    return table[tokens].to(compute_dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), the sigmoid spelled 1 / (1 +
    exp(-x)) and every op rounded to x's dtype, as the compiled reference
    expands it (a fused ``torch.sigmoid`` rounds once and disagrees in
    ~30% of bf16 outputs)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, each op rounded to the activation dtype."""
    return silu(gate) * up


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: x * 0.5 * (1 + tanh(c * (x +
    0.044715 * x**3))) with c = sqrt(2/pi), every op rounded to x's dtype
    and both constants rounded to it first, as JAX casts them.  On every
    bf16 input of magnitude above 1e-10 this is bitwise the reference's,
    jitted or eager (XLA flushes the tiny rest to zero);
    ``torch.nn.functional.gelu(approximate="tanh")`` rounds once and
    differs in about 1500 of the 65280 finite bf16 values."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype).item()
    k = torch.tensor(0.044715, dtype=x.dtype).item()
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))
