"""Encoder-decoder transformer (the Whisper-family backbone): config,
init, encoder, decoder, logits, cache.

Counterpart of ``src/repro/models/encdec.py``: ``EncDecConfig`` (with
``padded_vocab``, ``n_params``/``n_active_params`` and ``attn_cfg``),
the GELU FFN with biases (``_gelu_ffn_init``/``_gelu_ffn_apply``), the
cross-attention (``_xattn_init``/``_xattn_apply``), the encoder and
decoder blocks, ``init``, ``encode``, ``_enc_kv``, ``decode``,
``logits_from_hidden`` and ``init_cache``, with the reference's
arithmetic.  The conv/mel frontend is a stub, as in the reference: the
encoder reads precomputed frame embeddings (B, T_enc, d).

  * The encoder adds learned positions (bf16) and runs pre-LN blocks:
    self-attention with inline q/k/v projections, no RoPE and no mask,
    through ``chunked_attention(causal=False, chunk_kv=512)`` (500-wide
    chunks over 1500 frames), then the GELU FFN.
  * The decoder adds learned positions and runs pre-LN blocks: causal
    self-attention through ``attention.attn_apply``, which applies RoPE
    on top of the learned positions, as the reference's does; then
    cross-attention whose K/V (``_enc_kv``) are projected from the
    encoder output in every layer on every call, decode steps included,
    as the reference does; then the GELU FFN.  Decode writes at the
    cache's shared cursor (``per_slot=False``).
  * The logits read the embedding table (a tied head), fp32-accumulated,
    with the padded vocab columns set to ``-1e30``.

Every bf16 rounding the reference's source writes is kept: a bias is
added to the rounded product in bf16 (``layers.dense_apply``), the GELU
runs op by op in bf16 (``layers.gelu_tanh``), each LayerNorm reads the
rounded residual, and the learned positions are added in bf16.  So the
encoder output and the decoder's hidden states are bitwise the
reference's run eagerly, or compiled with XLA's excess precision off;
compiled with its defaults on the CPU, the reference keeps some of
these values in fp32 and its logits move by up to ~3e-2.

What differs:
  * parameters are Python lists of per-layer dicts under
    ``"enc_blocks"`` and ``"dec_blocks"``, and the stacks are Python
    loops, where the reference stacks leaves along a layer axis and
    scans; the cache is a list of per-layer ``{"k", "v", "pos"}`` dicts,
    updated in place;
  * ``init`` draws from a ``torch.Generator`` seeded with ``seed`` on an
    explicit device (the card unless ``device`` says otherwise);
  * rematerialization is per block with ``torch.utils.checkpoint``, in
    both stacks, only under autograd and never with a cache (the
    reference remats the encoder whenever ``remat`` is set and the
    decoder unless it decodes; without gradients it changes nothing);
  * the profiler ranges ``encdec/encoder``, ``encdec/decoder`` and
    ``encdec/cross_kv`` split a step's time.
  * the logical-axis specs come from ``init_specs`` (leaf paths,
    ``layers.leaf_spec``); each block reads its params through
    ``layers.gathered`` (a block kept in shards by ``sharding.fsdp``
    gathers them there).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparsity import DENSE, SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int          # decoder layers
    n_enc_layers: int      # encoder layers
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    max_source: int = 1500
    max_target: int = 448
    remat: bool = True
    # the embedding table is padded up to a multiple of this; padded
    # logit columns are masked to -1e30
    pad_vocab_to: int = 256

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.pad_vocab_to) * self.pad_vocab_to

    def n_params(self) -> int:
        """Total parameter count (shapes only: drawn on the meta
        device)."""
        return sum(t.numel() for t in _leaves(init(self, device="meta")))

    def n_active_params(self) -> int:
        return self.n_params()

    def attn_cfg(self) -> A.AttnConfig:
        return A.AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                            n_kv=self.n_kv, head_dim=self.head_dim)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _gelu_ffn_init(gen, d: int, d_ff: int, *, device, dtype=torch.float32):
    return {"w_in": L.dense_init(gen, d, d_ff, device=device, dtype=dtype,
                                 bias=True),
            "w_out": L.dense_init(gen, d_ff, d, device=device, dtype=dtype,
                                  bias=True)}


def _gelu_ffn_apply(p, x: torch.Tensor, sp_cfg) -> torch.Tensor:
    h = L.gelu_tanh(L.dense_apply(p["w_in"], x, "mlp/w_in", sp_cfg))
    return L.dense_apply(p["w_out"], h.to(x.dtype), "mlp/w_out", sp_cfg)


def _xattn_init(gen, cfg: EncDecConfig, *, device, dtype=torch.float32):
    """Cross-attention: q from the decoder, k/v from the encoder
    output."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    return {name: L.dense_init(gen, din, dout, device=device, dtype=dtype)
            for name, din, dout in (("q_proj", d, h * hd),
                                    ("k_proj", d, kv * hd),
                                    ("v_proj", d, kv * hd),
                                    ("o_proj", h * hd, d))}


def _xattn_apply(p, x: torch.Tensor, enc_kv, cfg: EncDecConfig, sp_cfg):
    """``enc_kv``: the (k, v) that ``_enc_kv`` projected from the
    encoder output."""
    h, hd = cfg.n_heads, cfg.head_dim
    q = L.dense_apply(p["q_proj"], x, "xattn/q_proj", sp_cfg)
    q = q.reshape(*x.shape[:-1], h, hd)
    k, v = enc_kv
    out = A.chunked_attention(q, k, v, causal=False, q_offset=0,
                              chunk_kv=512)
    out = out.reshape(*x.shape[:-1], h * hd)
    return L.dense_apply(p["o_proj"], out, "xattn/o_proj", sp_cfg)


def _enc_block_init(gen, cfg: EncDecConfig, *, device, dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {"ln1": L.layernorm_init(cfg.d_model, **kw),
            "ln2": L.layernorm_init(cfg.d_model, **kw),
            "attn": A.attn_init(gen, cfg.attn_cfg(), **kw),
            "ffn": _gelu_ffn_init(gen, cfg.d_model, cfg.d_ff, **kw)}


def _dec_block_init(gen, cfg: EncDecConfig, *, device, dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {"ln1": L.layernorm_init(cfg.d_model, **kw),
            "ln2": L.layernorm_init(cfg.d_model, **kw),
            "ln3": L.layernorm_init(cfg.d_model, **kw),
            "attn": A.attn_init(gen, cfg.attn_cfg(), **kw),
            "xattn": _xattn_init(gen, cfg, **kw),
            "ffn": _gelu_ffn_init(gen, cfg.d_model, cfg.d_ff, **kw)}


def init(cfg: EncDecConfig, *, seed: int = 0, device=None,
         dtype=torch.float32):
    """Random params from one generator seeded with ``seed``: the
    embedding table, the learned decoder and encoder positions (N(0, 1)
    x 0.01, fp32 draws), the encoder's and the decoder's per-layer
    blocks and the two final LayerNorms.  ``device="meta"`` draws
    shapes only."""
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    kw = dict(device=device, dtype=dtype)

    def positions(n):
        t = torch.randn((n, cfg.d_model), generator=gen, device=device,
                        dtype=torch.float32) * 0.01
        return t.to(dtype)

    p = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, **kw)}
    p["pos_embed_dec"] = positions(cfg.max_target)
    p["pos_embed_enc"] = positions(cfg.max_source)
    p["enc_blocks"] = [_enc_block_init(gen, cfg, **kw)
                       for _ in range(cfg.n_enc_layers)]
    p["dec_blocks"] = [_dec_block_init(gen, cfg, **kw)
                       for _ in range(cfg.n_layers)]
    p["enc_norm"] = L.layernorm_init(cfg.d_model, **kw)
    p["dec_norm"] = L.layernorm_init(cfg.d_model, **kw)
    return p


def abstract_params(cfg: EncDecConfig):
    """The param tree's shapes on the meta device, nothing allocated."""
    return init(cfg, device="meta")


def init_specs(cfg: EncDecConfig):
    """The logical-axis spec of every leaf of ``init(cfg)``
    (``layers.leaf_spec``): the reference's, ``enc_blocks`` and
    ``dec_blocks`` leaves without its leading "layer"."""
    return L.spec_tree(abstract_params(cfg))


def _enc_block(bp, x: torch.Tensor, cfg: EncDecConfig, sp_cfg):
    """One encoder block: bidirectional self-attention over every frame
    (no RoPE, no mask), then the GELU FFN, each pre-LN and residual."""
    acfg = cfg.attn_cfg()
    bp = L.gathered(bp)
    h = L.layernorm_apply(bp["ln1"], x)
    q = L.dense_apply(bp["attn"]["q_proj"], h, "attn/q_proj", sp_cfg)
    k = L.dense_apply(bp["attn"]["k_proj"], h, "attn/k_proj", sp_cfg)
    v = L.dense_apply(bp["attn"]["v_proj"], h, "attn/v_proj", sp_cfg)
    q = q.reshape(*h.shape[:-1], acfg.n_heads, acfg.head_dim)
    k = k.reshape(*h.shape[:-1], acfg.n_kv, acfg.head_dim)
    v = v.reshape(*h.shape[:-1], acfg.n_kv, acfg.head_dim)
    attn = A.chunked_attention(q, k, v, causal=False, q_offset=0,
                               chunk_kv=512)
    attn = attn.reshape(*h.shape[:-1], acfg.n_heads * acfg.head_dim)
    x = x + L.dense_apply(bp["attn"]["o_proj"], attn, "attn/o_proj", sp_cfg)
    return x + _gelu_ffn_apply(bp["ffn"], L.layernorm_apply(bp["ln2"], x),
                               sp_cfg)


def encode(params, frames: torch.Tensor, cfg: EncDecConfig,
           sp_cfg: SparsityConfig = DENSE) -> torch.Tensor:
    """frames: (B, T_enc, d) stub-frontend embeddings -> (B, T_enc, d)
    in bf16.  Under autograd with ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint`` (only its input is kept)."""
    with record_function("encdec/encoder"):
        x = frames.to(torch.bfloat16)
        t = x.shape[1]
        x = x + params["pos_embed_enc"][:t].to(x.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for bp in params["enc_blocks"]:
            if remat:
                x = checkpoint(_enc_block, bp, x, cfg, sp_cfg,
                               use_reentrant=False)
            else:
                x = _enc_block(bp, x, cfg, sp_cfg)
        return L.layernorm_apply(params["enc_norm"], x)


def _enc_kv(bp, enc_out: torch.Tensor, cfg: EncDecConfig, sp_cfg):
    """A decoder layer's cross-attention k and v, (B, T_enc, n_kv,
    head_dim) each, projected from the encoder output."""
    with record_function("encdec/cross_kv"):
        acfg = cfg.attn_cfg()
        k = L.dense_apply(bp["xattn"]["k_proj"], enc_out, "xattn/k_proj",
                          sp_cfg)
        v = L.dense_apply(bp["xattn"]["v_proj"], enc_out, "xattn/v_proj",
                          sp_cfg)
        k = k.reshape(*enc_out.shape[:-1], acfg.n_kv, acfg.head_dim)
        v = v.reshape(*enc_out.shape[:-1], acfg.n_kv, acfg.head_dim)
        return k, v


def _dec_block(bp, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: EncDecConfig, sp_cfg, positions, cache=None,
               decode_step: bool = False):
    """One decoder block: causal self-attention (RoPE at ``positions``;
    with a cache, the prefill fills it or a decode step writes at its
    shared cursor), cross-attention to the encoder output, the GELU FFN.
    Returns (x, cache)."""
    bp = L.gathered(bp)
    h = L.layernorm_apply(bp["ln1"], x)
    mix, cache = A.attn_apply(bp["attn"], h, cfg.attn_cfg(), sp_cfg,
                              positions=positions, cache=cache,
                              decode=decode_step, per_slot=False)
    x = x + mix
    h2 = L.layernorm_apply(bp["ln2"], x)
    kv = _enc_kv(bp, enc_out, cfg, sp_cfg)
    x = x + _xattn_apply(bp["xattn"], h2, kv, cfg, sp_cfg)
    x = x + _gelu_ffn_apply(bp["ffn"], L.layernorm_apply(bp["ln3"], x),
                            sp_cfg)
    return x, cache


def _dec_block_out(bp, x, enc_out, cfg, sp_cfg, positions):
    return _dec_block(bp, x, enc_out, cfg, sp_cfg, positions)[0]


def decode(params, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: EncDecConfig, sp_cfg: SparsityConfig = DENSE, *, cache=None,
           decode_step: bool = False, positions=None):
    """The decoder trunk: returns (hidden (B, S, d), cache).

    Without a cache: the whole target sequence (training; under autograd
    with ``cfg.remat`` each block is rematerialized).  With a cache and
    ``decode_step=False``: a prefill that writes positions [0, S) and
    sets every layer's cursor to S.  With ``decode_step``: tokens (B, 1)
    at ``positions`` (B, 1) (the learned position and RoPE), every row
    writing at each layer's shared cursor, clamped into the cache, which
    then moves on by one."""
    with record_function("encdec/decoder"):
        x = L.embed_apply(params["embed"], tokens)
        b, s = x.shape[0], x.shape[1]
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        x = x + params["pos_embed_dec"][positions].to(x.dtype)
        layer_caches = cache["layers"] if cache is not None else None
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, bp in enumerate(params["dec_blocks"]):
            if remat:
                x = checkpoint(_dec_block_out, bp, x, enc_out, cfg, sp_cfg,
                               positions, use_reentrant=False)
            else:
                lc = layer_caches[i] if layer_caches is not None else None
                x, _ = _dec_block(bp, x, enc_out, cfg, sp_cfg, positions, lc,
                                  decode_step)
        return L.layernorm_apply(params["dec_norm"], x), cache


def logits_from_hidden(params, hidden: torch.Tensor,
                       cfg: EncDecConfig) -> torch.Tensor:
    """hidden @ the embedding table's transpose with fp32 accumulation;
    padded columns -1e30.  The table gets its gradient from both
    uses."""
    w = params["embed"]["embed_table"].t()
    logits = L.head_product(hidden.reshape(-1, hidden.shape[-1]), w)
    logits = logits.reshape(*hidden.shape[:-1], w.shape[-1])
    if cfg.padded_vocab != cfg.vocab:
        valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(valid, logits, -1e30)
    return logits


def loss(params, hidden: torch.Tensor, labels: torch.Tensor,
         cfg: EncDecConfig) -> torch.Tensor:
    """The reference step's loss: the mean of ``logsumexp(logits) -
    logits[label]`` over every (row, position), from fp32 logits."""
    logits = logits_from_hidden(params, hidden, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def init_cache(cfg: EncDecConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16):
    """``{"layers": [{"k", "v", "pos"} a decoder layer]}``, k and v
    (B, max_len, n_kv, head_dim) zeros in ``dtype``, the cursor 0."""
    return {"layers": [A.init_cache(cfg.attn_cfg(), batch, max_len,
                                    device=device, dtype=dtype)
                       for _ in range(cfg.n_layers)]}

