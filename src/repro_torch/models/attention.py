"""GQA attention with RoPE and qk-norm: prefill and per-slot decode.

Counterpart of the GQA path of ``src/repro/models/attention.py``:
``AttnConfig``, ``attn_init``, ``chunked_attention`` (online softmax over
KV chunks), ``decode_attention``, ``attn_apply`` and ``init_cache``.
The arithmetic mirrors the reference: logits as an einsum of bf16 values
accumulated in fp32, fp32 softmax, ``-1e30`` masks, probabilities cast
to the value dtype before the PV product.  No fused attention operator
is used, so the CPU comparison with the reference stays exact in
structure.

What differs:
  * sliding-window (banded) attention and MLA are not ported;
  * decode is per-slot only (every row at its own position, the serve
    engine's mode); the reference's synchronized shared-cursor decode is
    not ported;
  * caches are updated in place (``index_put_``/slice assignment) where
    the reference returns new arrays, which saves a cache copy per
    layer and step; ``attn_apply`` still returns the cache it wrote.
Layouts are the reference's: q/k/v (B, S, H, D), caches (B, S, Hkv, D).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    chunk_kv: int = 1024


def attn_init(gen: torch.Generator, cfg: AttnConfig, *, device,
              dtype=torch.float32):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {}
    for name, dout in (("q_proj", h * hd), ("k_proj", kv * hd),
                       ("v_proj", kv * hd)):
        p[name] = L.dense_init(gen, d, dout, device=device, dtype=dtype)
    p["o_proj"] = L.dense_init(gen, h * hd, d, device=device, dtype=dtype)
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, device=device, dtype=dtype)
        p["k_norm"] = L.rmsnorm_init(hd, device=device, dtype=dtype)
    return p


def _largest_divisor(n: int, cap: int) -> int:
    cap = min(cap, n)
    for c in range(cap, 0, -1):
        if n % c == 0:
            return c
    return 1


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,D), k: (B,Ck,Hkv,D) -> (B,Hkv,G,Sq,Ck) fp32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                        k.to(torch.float32))


def _pv(p: torch.Tensor, v: torch.Tensor, spec: str) -> torch.Tensor:
    """Probabilities cast to v's dtype, then an fp32-accumulated product."""
    return torch.einsum(spec, p.to(v.dtype).to(torch.float32),
                        v.to(torch.float32))


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      chunk_kv: int = 1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); q_offset: absolute position
    of q[0] for the causal mask.
    """
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    chunk_kv = _largest_divisor(skv, chunk_kv)
    qg = q.reshape(b, sq, hkv, g, d)
    scale = d ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for j in range(skv // chunk_kv):
        kj = k[:, j * chunk_kv:(j + 1) * chunk_kv]
        vj = v[:, j * chunk_kv:(j + 1) * chunk_kv]
        logits = _gqa_logits(qg, kj) * scale
        k_pos = j * chunk_kv + torch.arange(chunk_kv, device=q.device)
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _pv(p, vj, "bhgqk,bkhd->bhgqd")
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def decode_attention(q1, k_cache, v_cache, cur_pos: torch.Tensor):
    """Single-step decode: q1 (B,1,H,D) vs cache (B,Smax,Hkv,D); cur_pos
    (B,) per-request positions (keys at k_pos <= cur_pos attend)."""
    b, _, h, d = q1.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = d ** -0.5
    k_pos = torch.arange(smax, device=q1.device)
    qg = q1.reshape(b, 1, hkv, g, d)
    logits = _gqa_logits(qg, k_cache) * scale            # (B,Hkv,G,1,S)
    mask = k_pos[None, :] <= cur_pos[:, None]            # (B,S)
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    out = _pv(attn, v_cache, "bhgqk,bkhd->bqhgd")
    return out.reshape(b, 1, h, d).to(q1.dtype)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, d)


def attn_apply(p, x: torch.Tensor, cfg: AttnConfig, sp_cfg, *,
               positions: torch.Tensor, cache=None, decode: bool = False):
    """Returns (out, cache).

    Prefill (``decode=False``): causal attention over x's S tokens; with a
    cache, k/v are written into positions [0, S) and ``cache["pos"]`` set
    to S.  Decode: x is (B, 1, d) and row i writes its k/v at
    ``clip(positions[i, -1], 0, max_len - 1)`` — free slots too, whose
    garbage stays masked — then attends to keys at or before its own
    position.
    """
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = _split_heads(L.dense_apply(p["q_proj"], x, "attn/q_proj", sp_cfg),
                     h, hd)
    k = _split_heads(L.dense_apply(p["k_proj"], x, "attn/k_proj", sp_cfg),
                     kv, hd)
    v = _split_heads(L.dense_apply(p["v_proj"], x, "attn/v_proj", sp_cfg),
                     kv, hd)
    if cfg.qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q)
        k = L.rmsnorm_apply(p["k_norm"], k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        b = x.shape[0]
        cur = positions[:, -1]
        wpos = torch.clamp(cur, 0, cache["k"].shape[1] - 1)
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, wpos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, wpos] = v[:, 0].to(cache["v"].dtype)
        cache["pos"] = cache["pos"] + 1
        out = decode_attention(q, cache["k"], cache["v"], cur)
    else:
        out = chunked_attention(q, k, v, causal=True, q_offset=0,
                                chunk_kv=cfg.chunk_kv)
        if cache is not None:
            s = k.shape[1]
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
            cache["pos"] = s
    out = out.reshape(*x.shape[:-1], h * hd)
    return L.dense_apply(p["o_proj"], out, "attn/o_proj", sp_cfg), cache


def init_cache(cfg: AttnConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16):
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
