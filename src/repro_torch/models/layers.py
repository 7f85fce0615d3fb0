"""Shared layer primitives on plain parameter dicts.

Counterpart of ``src/repro/models/layers.py``: ``dense_init``,
``dense_apply``, ``rmsnorm_init``/``rmsnorm_apply``, ``embed_init``/
``embed_apply``, ``rope_freqs``, ``apply_rope`` and ``swiglu``, with the
reference's arithmetic: rmsnorm in fp32 cast back to the input dtype,
RoPE over the two halves of head_dim (not interleaved pairs) in fp32,
SiLU as the compiled reference computes it in bf16.

What differs: no logical-axis spec trees (sharding is not ported), and
init draws from an explicit ``torch.Generator`` on an explicit device —
the same seed gives other numbers than ``jax.random``, so parity tests
load the reference's weights through ``convert.params_from_jax``.
"""

from __future__ import annotations

import torch

from repro_torch.core import operand as O
from repro_torch.core.sparsity import SparsityConfig


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
               dtype=torch.float32):
    """{"w": (d_in, d_out)} ~ N(0, 1) * d_in**-0.5, drawn in fp32."""
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32) * d_in ** -0.5
    return {"w": w.to(dtype)}


def dense_apply(p, x: torch.Tensor, name: str, cfg: SparsityConfig,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ w through the SparseOperand seam (``core.operand.nm_apply``);
    ``p["w"]`` is a weight tensor (masked per ``bdwp.pick_cfg``) or an
    operand such as a ``PackedOp`` or a ``SharedOp``; a ``p`` without
    ``"w"`` is itself a flat packed ``{"vals", "idx"}`` dict (the
    shared-packed layout of older packers)."""
    op = O.as_operand(p["w"] if "w" in p else p, name, cfg)
    return O.nm_apply(op, x.to(compute_dtype))


def rmsnorm_init(d: int, *, device, dtype=torch.float32):
    return {"norm_scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6,
                  out_dtype=None) -> torch.Tensor:
    """RMSNorm in fp32, cast to ``out_dtype`` (default: x's dtype)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["norm_scale"]
    return out.to(out_dtype or x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device,
               dtype=torch.float32):
    t = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32) * d ** -0.5
    return {"embed_table": t.to(dtype)}


def embed_apply(p, tokens: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    return p["embed_table"][tokens].to(compute_dtype)


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


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up, with the sigmoid spelled 1 / (1 + exp(-x)) and
    every op rounded to the activation dtype, as the compiled reference
    expands ``jax.nn.silu`` (a fused ``torch.sigmoid`` rounds once and
    disagrees in ~30% of bf16 outputs)."""
    return gate * (1.0 / (1.0 + torch.exp(-gate))) * up
