"""GQA attention with RoPE, qk-norm, QKV bias and sliding windows, and
DeepSeek-V2's multi-head latent attention (MLA): prefill, per-slot and
shared-cursor decode.

Counterpart of ``src/repro/models/attention.py``:
``AttnConfig``, ``attn_init`` (QKV bias), ``chunked_attention`` (online
softmax over KV chunks), ``banded_attention`` (sliding-window prefill:
query chunks of ``chunk_q`` against a KV band padded to whole chunks,
the exact window mask, O(S*W)), ``decode_attention`` (per-slot
positions with a window mask, or one shared position with the last
``window`` positions sliced), ``attn_apply``, ``_mla_apply`` (MLA:
a compressed ``(ckv, kpe)`` cache; prefill expands it through
``k_up``/``v_up``, decode attends in the ``kv_lora``-wide latent space
through the absorbed matrices) and ``init_cache``.
The arithmetic mirrors the reference: logits as an einsum of bf16 values
accumulated in fp32, fp32 softmax, ``-1e30`` masks, probabilities cast
to the value dtype before the PV product.  No fused attention operator
is used, so the CPU comparison with the reference stays exact in
structure.

What differs:
  * decode defaults to per-slot (``per_slot=True``, the serve engine's
    mode), where the reference's ``attn_apply`` defaults to the shared
    cursor;
  * the chunk loops are Python loops, not scans;
  * caches are updated in place (``index_put_``/slice assignment) where
    the reference returns new arrays, which saves a cache copy per
    layer and step; ``attn_apply`` still returns the cache it wrote.
  * the absorbed MLA decode's fp32 products run at full fp32 precision
    on the card (TF32 off for their span), as the reference's fp32
    einsums;
  * inside ``sharding.tp.model_split`` ``attn_apply`` runs the rank's
    heads (``_head_plan``): its query heads from o_proj's row block, its
    KV heads from its cache block, q/k/v from its column blocks
    (gathered where a block does not hold the heads it needs), o_proj
    summed over "model";
Layouts are the reference's: q/k/v (B, S, H, D), caches (B, S, Hkv, D),
an MLA cache ``ckv`` (B, S, kv_lora) and ``kpe`` (B, S, qk_rope_dim).

The absorbed decode reads ``k_up``/``v_up``'s raw weights, as the
reference does (its ``attention.py:364,377``): serving never packs or
masks them, so a sparse model decodes through dense latent
up-projections while its prefill masks them (ROADMAP queue 3, the
reference hazard).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.sharding import tp

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    # MLA (deepseek-v2): with kv_lora set, the layer keeps a compressed
    # KV cache of kv_lora + qk_rope_dim values a position
    kv_lora: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: Optional[int] = None
    chunk_q: int = 1024
    chunk_kv: int = 1024


def attn_init(gen: torch.Generator, cfg: AttnConfig, *, device,
              dtype=torch.float32):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {}
    if cfg.kv_lora is not None:
        # the reference's order: q_proj, kv_down, k_up, v_up, o_proj
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        dv = cfg.v_head_dim or dn
        for name, din, dout in (("q_proj", d, h * (dn + dr)),
                                ("kv_down", d, cfg.kv_lora + dr),
                                ("k_up", cfg.kv_lora, h * dn),
                                ("v_up", cfg.kv_lora, h * dv),
                                ("o_proj", h * dv, d)):
            p[name] = L.dense_init(gen, din, dout, device=device, dtype=dtype)
        p["ckv_norm"] = L.rmsnorm_init(cfg.kv_lora, device=device,
                                       dtype=dtype)
        return p
    for name, dout in (("q_proj", h * hd), ("k_proj", kv * hd),
                       ("v_proj", kv * hd)):
        p[name] = L.dense_init(gen, d, dout, device=device, dtype=dtype,
                               bias=cfg.qkv_bias)
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


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis.  On the CPU as ``jax.nn.softmax``
    computes it, exp of the max-shifted logits divided by their sum
    (``torch.softmax`` there multiplies by the sum's reciprocal, an ulp
    away from the reference); on the card ``torch.softmax``, one kernel
    where the spelled-out form takes five a call."""
    if logits.is_cuda:
        return torch.softmax(logits, -1)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      chunk_kv: int = 1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); q_offset: absolute position
    of q[0] for the causal mask.  Batch-invariant under
    ``layers.batch_invariant``.
    """
    return L.batch_padded(lambda q_, k_, v_: _chunked_attention(
        q_, k_, v_, causal=causal, q_offset=q_offset, chunk_kv=chunk_kv),
        q, k, v)


def _chunked_attention(q, k, v, *, causal: bool, q_offset: int,
                       chunk_kv: int):
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


def banded_attention(q, k, v, *, window: int, chunk_q: int = 1024):
    """Sliding-window causal attention in O(S*W): query i attends to keys
    j with i - window < j <= i.

    Query chunks of ``chunk_q`` (the largest divisor of S not above it)
    each read a KV band of ``w_pad + chunk_q`` positions, ``w_pad`` the
    window rounded up to whole chunks, from K and V padded at the front
    with ``w_pad`` zeros (masked); softmax over the band, as the
    reference's scan step does.
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    chunk_q = _largest_divisor(s, chunk_q)
    w_pad = -(-window // chunk_q) * chunk_q
    span = w_pad + chunk_q
    scale = d ** -0.5
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, w_pad, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, w_pad, 0))
    ar_q = torch.arange(chunk_q, device=q.device)
    ar_k = torch.arange(span, device=q.device)
    outs = []
    for q0 in range(0, s, chunk_q):
        qg = q[:, q0:q0 + chunk_q].reshape(b, chunk_q, hkv, g, d)
        logits = _gqa_logits(qg, kp[:, q0:q0 + span]) * scale
        q_pos = (q0 + ar_q)[:, None]
        k_pos = (q0 - w_pad + ar_k)[None, :]
        mask = (q_pos >= k_pos) & (q_pos - k_pos < window) & (k_pos >= 0)
        logits = torch.where(mask, logits, NEG_INF)
        out = _pv(_softmax(logits), vp[:, q0:q0 + span],
                  "bhgqk,bkhd->bqhgd")
        outs.append(out.reshape(b, chunk_q, h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q1, k_cache, v_cache, cur_pos, *,
                     window: Optional[int] = None):
    """Single-step decode: q1 (B,1,H,D) vs cache (B,Smax,Hkv,D).

    ``cur_pos`` is a (B,) tensor of per-request positions (each row
    attends to keys at k_pos <= its position, and with a window to the
    last ``window`` of them, by mask) or an int, the whole batch's one
    position; then a window smaller than the cache slices the last
    ``window`` positions, clipped into the cache, so the work is O(W).
    Batch-invariant under ``layers.batch_invariant``.
    """
    if isinstance(cur_pos, torch.Tensor) and cur_pos.ndim > 0:
        return L.batch_padded(lambda q_, k_, v_, p_: _decode_attention(
            q_, k_, v_, p_, window=window), q1, k_cache, v_cache, cur_pos)
    return L.batch_padded(lambda q_, k_, v_: _decode_attention(
        q_, k_, v_, cur_pos, window=window), q1, k_cache, v_cache)


def _decode_attention(q1, k_cache, v_cache, cur_pos, *, window):
    b, _, h, d = q1.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = d ** -0.5
    per_slot = isinstance(cur_pos, torch.Tensor) and cur_pos.ndim > 0
    start = 0
    if window is not None and window < smax and not per_slot:
        start = min(max(int(cur_pos) + 1 - window, 0), smax - window)
        k_cache = k_cache[:, start:start + window]
        v_cache = v_cache[:, start:start + window]
    k_pos = start + torch.arange(k_cache.shape[1], device=q1.device)
    qg = q1.reshape(b, 1, hkv, g, d)
    logits = _gqa_logits(qg, k_cache) * scale            # (B,Hkv,G,1,S)
    if per_slot:
        mask = k_pos[None, :] <= cur_pos[:, None]        # (B,S)
        if window is not None:
            mask &= (cur_pos[:, None] - k_pos[None, :]) < window
    else:
        mask = (k_pos <= int(cur_pos))[None, :]
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    attn = _softmax(logits)
    out = _pv(attn, v_cache, "bhgqk,bkhd->bqhgd")
    return out.reshape(b, 1, h, d).to(q1.dtype)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, d)


def attn_apply(p, x: torch.Tensor, cfg: AttnConfig, sp_cfg, *,
               positions: torch.Tensor, cache=None,
               layer_window: Optional[int] = None, decode: bool = False,
               per_slot: bool = True):
    """Returns (out, cache).  ``layer_window`` is this layer's sliding
    window (None: global attention).

    Prefill (``decode=False``): causal attention over x's S tokens,
    banded when the layer has a window; with a cache, k/v are written
    into positions [0, S) and ``cache["pos"]`` set to S.  Decode: x is
    (B, 1, d); per slot, row i writes its k/v at ``clip(positions[i,
    -1], 0, max_len - 1)`` (free slots too, whose garbage stays masked)
    and attends to keys at or before its own position; with the shared
    cursor (``per_slot=False``) every row writes at ``cache["pos"]``
    (clipped in the same way) and attends to keys at or before it.
    Either way ``cache["pos"]`` then moves on by one.  An MLA config
    (``cfg.kv_lora``) takes ``_mla_apply``.
    """
    if cfg.kv_lora is not None:
        return _mla_apply(p, x, cfg, sp_cfg, positions=positions,
                          cache=cache, decode=decode, per_slot=per_slot)
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    (q0, q1), (c0, c1), (a0, a1) = _head_plan(p, cfg, cache)
    q = _split_heads(L.column_apply(p["q_proj"], x, "attn/q_proj", sp_cfg,
                                    h * hd, (q0 * hd, q1 * hd)), q1 - q0, hd)
    k = _split_heads(L.column_apply(p["k_proj"], x, "attn/k_proj", sp_cfg,
                                    kv * hd, (c0 * hd, c1 * hd)), c1 - c0, hd)
    v = _split_heads(L.column_apply(p["v_proj"], x, "attn/v_proj", sp_cfg,
                                    kv * hd, (c0 * hd, c1 * hd)), c1 - c0, hd)
    if cfg.qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q)
        k = L.rmsnorm_apply(p["k_norm"], k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    def heads(t):   # the KV heads the rank's query heads read
        return t if (a0, a1) == (c0, c1) else t[:, :, a0 - c0:a1 - c0]

    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        smax = cache["k"].shape[1]
        if per_slot:
            cur = positions[:, -1]
            wpos = torch.clamp(cur, 0, smax - 1)
            rows = torch.arange(x.shape[0], device=x.device)
            cache["k"][rows, wpos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, wpos] = v[:, 0].to(cache["v"].dtype)
        else:
            cur = int(cache["pos"])
            wpos = min(max(cur, 0), smax - 1)
            cache["k"][:, wpos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, wpos] = v[:, 0].to(cache["v"].dtype)
        cache["pos"] = cache["pos"] + 1
        out = decode_attention(q, heads(cache["k"]), heads(cache["v"]), cur,
                               window=layer_window)
    else:
        if layer_window is not None:
            out = banded_attention(q, heads(k), heads(v),
                                   window=layer_window, chunk_q=cfg.chunk_q)
        else:
            out = chunked_attention(q, heads(k), heads(v), causal=True,
                                    q_offset=0, chunk_kv=cfg.chunk_kv)
        if cache is not None:
            s = k.shape[1]
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
            cache["pos"] = s
    out = out.reshape(*x.shape[:-1], (q1 - q0) * hd)
    return L.row_apply(p["o_proj"], out, "attn/o_proj", sp_cfg, h * hd,
                       (q0 * hd, q1 * hd)), cache


def _head_plan(p, cfg: AttnConfig, cache):
    """The heads a rank computes, as ((q0, q1), (c0, c1), (a0, a1)): its
    query heads [q0, q1), the KV heads it projects and caches [c0, c1),
    and the KV heads its query heads read [a0, a1), inside [c0, c1).
    Every head outside a ``sharding.tp.model_split``.  Inside one: the
    query heads covering o_proj's row block, widened to whole GQA groups
    where they hold parts of more than one (a head it computes and
    o_proj does not read is dropped there); the KV heads of the rank's
    cache block (every head where the cache is replicated over heads,
    or with no cache, those it reads)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    split = tp.current()
    if split is None:
        return (0, h), (0, kv), (0, kv)
    g = h // kv
    r0, r1 = split.held(L.local_dims(p["o_proj"]["w"])[0], h * hd)
    q0, q1 = r0 // hd, -(-r1 // hd)   # the query heads of those rows
    a0, a1 = q0 // g, (q1 - 1) // g + 1
    if a1 - a0 > 1 and (q0 % g or q1 % g):
        q0, q1 = a0 * g, a1 * g       # partial GQA groups: whole ones
    if cache is None:
        c0, c1 = a0, a1
    else:
        c0, c1 = split.held(cache["k"].shape[2], kv)
    if not c0 <= a0 <= a1 <= c1:
        raise NotImplementedError(
            f"query heads {q0}..{q1} read KV heads {a0}..{a1}, outside "
            f"the rank's cache heads {c0}..{c1}")
    return (q0, q1), (c0, c1), (a0, a1)


@contextlib.contextmanager
def _full_fp32_matmuls():
    """fp32 matmuls at full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _raw_weight(p, name: str) -> torch.Tensor:
    w = p[name]["w"]
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"the absorbed MLA decode reads {name} as a plain "
                        f"weight, got {type(w).__name__}")
    return w


def _mla_apply(p, x: torch.Tensor, cfg: AttnConfig, sp_cfg, *, positions,
               cache, decode: bool, per_slot: bool = True):
    """DeepSeek-V2 multi-head latent attention: returns (out, cache).

    q_proj gives each head a (qk_nope_dim + qk_rope_dim) query; kv_down
    gives the kv_lora-wide latent ``ckv`` (RMS-normed by ``ckv_norm``)
    and one shared rope key ``k_pe``; the cache keeps (ckv, k_pe).
    Prefill expands ckv through k_up and v_up (masked like any weight)
    and runs ``chunked_attention`` on (B, S, H, dn + dr) queries and keys
    (k_pe broadcast over the heads) and (B, S, H, dv) values.  Decode
    writes the new position as ``attn_apply`` does (per slot, or at the
    shared cursor) and attends in the latent space in fp32: q_nope
    absorbed into k_up's raw weight, scores against ckv plus the rope
    scores, the (dn + dr) ** -0.5 scale, the context mapped out through
    v_up's raw weight.
    """
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    dv = cfg.v_head_dim or dn
    lora = cfg.kv_lora
    b = x.shape[0]

    qall = L.dense_apply(p["q_proj"], x, "attn/q_proj", sp_cfg)
    qall = qall.reshape(*x.shape[:-1], h, dn + dr)
    q_nope, q_pe = qall[..., :dn], qall[..., dn:]
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)

    down = L.dense_apply(p["kv_down"], x, "attn/kv_down", sp_cfg)
    ckv = L.rmsnorm_apply(p["ckv_norm"], down[..., :lora])
    k_pe = L.apply_rope(down[..., None, lora:], positions,
                        cfg.rope_theta)[..., 0, :]

    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        smax = cache["ckv"].shape[1]
        if per_slot:
            cur = positions[:, -1]
            wpos = torch.clamp(cur, 0, smax - 1)
            rows = torch.arange(b, device=x.device)
            cache["ckv"][rows, wpos] = ckv[:, 0].to(cache["ckv"].dtype)
            cache["kpe"][rows, wpos] = k_pe[:, 0].to(cache["kpe"].dtype)
        else:
            cur = int(cache["pos"])
            wpos = min(max(cur, 0), smax - 1)
            cache["ckv"][:, wpos] = ckv[:, 0].to(cache["ckv"].dtype)
            cache["kpe"][:, wpos] = k_pe[:, 0].to(cache["kpe"].dtype)
            cur = torch.full((b,), cur, device=x.device)
        cache["pos"] = cache["pos"] + 1
        f32 = torch.float32
        ckv_c = cache["ckv"].to(f32)
        with _full_fp32_matmuls():
            wk = _raw_weight(p, "k_up").reshape(lora, h, dn).to(f32)
            q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope.to(f32), wk)
            scores = torch.einsum("bqhl,bsl->bhqs", q_abs, ckv_c)
            scores = scores + torch.einsum("bqhd,bsd->bhqs", q_pe.to(f32),
                                           cache["kpe"].to(f32))
            scores = scores * (dn + dr) ** -0.5
            mask = torch.arange(smax, device=x.device)[None, :] <= cur[:, None]
            scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
            ctx_c = torch.einsum("bhqs,bsl->bqhl", _softmax(scores), ckv_c)
            wv = _raw_weight(p, "v_up").reshape(lora, h, dv).to(f32)
            ctx = torch.einsum("bqhl,lhv->bqhv", ctx_c, wv)
    else:
        k_nope = L.dense_apply(p["k_up"], ckv, "attn/k_up", sp_cfg)
        k_nope = k_nope.reshape(*x.shape[:-1], h, dn)
        val = L.dense_apply(p["v_up"], ckv, "attn/v_up", sp_cfg)
        val = val.reshape(*x.shape[:-1], h, dv)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe[..., None, :].expand(
            *k_pe.shape[:-1], h, dr)], dim=-1)
        ctx = chunked_attention(q, k, val, causal=True, q_offset=0,
                                chunk_kv=cfg.chunk_kv)
        if cache is not None:
            s = x.shape[1]
            cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
            cache["kpe"][:, :s] = k_pe.to(cache["kpe"].dtype)
            cache["pos"] = s
    ctx = ctx.reshape(*x.shape[:-1], h * dv).to(x.dtype)
    return L.dense_apply(p["o_proj"], ctx, "attn/o_proj", sp_cfg), cache


def init_cache(cfg: AttnConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16):
    if cfg.kv_lora is not None:
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora),
                                   dtype=dtype, device=device),
                "kpe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                   dtype=dtype, device=device),
                "pos": 0}
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
