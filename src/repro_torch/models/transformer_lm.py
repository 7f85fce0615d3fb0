"""Decoder LM (the dense, MoE, SSM and hybrid families): config, init,
forward, logits, cache.

Counterpart of ``src/repro/models/transformer_lm.py``: ``LMConfig``
(with ``n_params``/``n_active_params``), ``ffn_init``/``ffn_apply``,
the block (a dense FFN or a mixture of experts, ``models.moe``),
``init``, ``forward`` (with per-block rematerialization when training,
a modality prefix, and the MoE aux loss summed over layers),
``logits_from_hidden`` (an untied lm_head, or the embedding table when
``tie_embed``), ``lm_loss`` and ``init_lm_cache``, with the
reference's arithmetic (bf16 residual stream, fp32-accumulated logits
with the padded vocab columns set to ``-1e30``).  It covers the dense
family: qwen3 (qk_norm), qwen2.5 (QKV bias), glm4, gemma3 (the 5:1
pattern of sliding-window and global layers, a tied head) and
internvl2's LM (a stub-frontend prefix); granite-moe (every block's
FFN a mixture of experts); deepseek-v2-lite (multi-head latent
attention, a mixture of experts with shared experts, and a dense first
layer, the "prelude", outside the stack of blocks); mamba2 (every
layer a Mamba-2 SSD block, ``models.ssm``, and no attention or FFN);
and hymba (every layer runs sliding-window attention and an SSD block
on the same input and takes their mean, then a dense FFN).

What differs:
  * ``LMConfig`` is the port's own copy, with the reference's layer
    kinds "attn", "swa", "mamba" and "hybrid";
  * parameters are a Python list of per-layer dicts under ``"blocks"``
    and ``forward`` loops over it, choosing each layer's window from
    ``layer_kinds()`` in Python, where the reference stacks leaves
    along a layer axis, scans, and picks local or global attention with
    ``lax.cond`` on a per-layer flag; caches likewise are a list of
    per-layer ``{"k", "v", "pos"}`` (MLA: ``{"ckv", "kpe", "pos"}``;
    mamba: the fp32 ``{"state", "conv"}``; hybrid: both) dicts, updated
    in place; the prelude (``params["prelude"]``,
    ``cache["prelude"]``) is a separate subtree beside them, as in the
    reference, and runs through ``block_apply`` as a block with a dense
    FFN of width ``first_dense_ff``;
  * ``init`` draws from a ``torch.Generator`` seeded with ``seed`` on an
    explicit device (the card unless ``device`` says otherwise);
    ``init_shell``/``iter_blocks`` give the same draws one layer at a
    time, so a full-width model can be packed without holding every
    dense layer at once.
  * the logical-axis specs come from ``init_specs`` (leaf paths,
    ``layers.leaf_spec``) and the shapes from ``abstract_params`` (the
    meta device), where the reference's ``init(..., abstract=True)``
    returns both; ``forward`` reads each block through
    ``layers.gathered``, so a block kept in shards (``sharding.fsdp``)
    gathers its operands inside its own recompute;
  * inside ``sharding.tp.model_split`` (the serve steps over a "model"
    axis) the embedding, the attention, the FFN and the logits run on
    the rank's blocks, with explicit collectives where the reference's
    ``act()`` points let GSPMD insert them: a vocab-parallel lookup,
    row-parallel sums after o_proj and w_down, the logits gathered
    whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparsity import DENSE, SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.sharding import tp

KINDS = ("attn", "swa", "mamba", "hybrid")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 128
    d_ff: int = 0
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    # layer pattern, cycled over depth: "attn" (global) | "swa" (window)
    # | "mamba" (an SSD block alone) | "hybrid" (windowed attention and
    # an SSD block on the same input, mean-combined)
    pattern: tuple = ("attn",)
    window: Optional[int] = None
    # MoE: every block's FFN is a mixture of experts
    moe: Optional[M.MoEConfig] = None
    first_dense_ff: Optional[int] = None  # deepseek: dense FFN in layer 0
    # MLA (deepseek-v2): compressed KV of width kv_lora
    kv_lora: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: Optional[int] = None
    # SSM (mamba2, hymba): state width, head width, SSD chunk length
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # the logits read the embedding table (no lm_head), as the
    # reference's default; the untied configs say tie_embed=False
    tie_embed: bool = True
    # the embedding and lm_head tables are padded up to a multiple of
    # this; padded logit columns are masked to -1e30
    pad_vocab_to: int = 256
    # training recomputes each block in the backward pass instead of
    # keeping its activations
    remat: bool = True

    def __post_init__(self):
        unknown = set(self.pattern) - set(KINDS)
        if unknown:
            raise ValueError(f"{self.name}: unknown layer kinds "
                             f"{sorted(unknown)}; known: {list(KINDS)}")
        if "swa" in self.pattern and not self.window:
            raise ValueError(f"{self.name}: swa layers need a window")

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.pad_vocab_to) * self.pad_vocab_to

    def layer_kinds(self) -> list:
        """Each layer's kind, the pattern cycled over depth."""
        pat = self.pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    @property
    def uses_scan_prelude(self) -> bool:
        """Is layer 0 a dense prelude outside the stack of blocks?"""
        return self.first_dense_ff is not None

    @property
    def n_blocks(self) -> int:
        """Layers in ``params["blocks"]``: all but the prelude."""
        return self.n_layers - (1 if self.uses_scan_prelude else 0)

    def block_kinds(self) -> list:
        """The kinds of the layers in ``params["blocks"]``."""
        return self.layer_kinds()[self.n_layers - self.n_blocks:]

    def layer_window(self, kind: str) -> Optional[int]:
        """The sliding window of a layer of ``kind`` (None: global); a
        hybrid layer's attention takes ``window``, as the reference's."""
        return self.window if kind in ("swa", "hybrid") else None

    @property
    def has_attn(self) -> bool:
        return any(k in ("attn", "swa", "hybrid") for k in self.layer_kinds())

    @property
    def has_ssm(self) -> bool:
        return any(k in ("mamba", "hybrid") for k in self.layer_kinds())

    def n_params(self) -> int:
        """Total parameter count (shapes only: drawn on the meta
        device); the shell holds the prelude."""
        shell = init_shell(self, None, device="meta")
        block = block_init(None, self, device="meta")
        count = sum(t.numel() for t in _leaves(shell))
        return count + self.n_blocks * sum(t.numel() for t in _leaves(block))

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of the routed
        experts)."""
        total = self.n_params()
        if self.moe is None:
            return total
        e, k = self.moe.n_experts, self.moe.top_k
        expert_p = 3 * self.d_model * self.moe.d_expert
        return total - self.n_blocks * (e - k) * expert_p

    def attn_cfg(self) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.head_dim, rope_theta=self.rope_theta,
            qk_norm=self.qk_norm, qkv_bias=self.qkv_bias,
            kv_lora=self.kv_lora, qk_nope_dim=self.qk_nope_dim,
            qk_rope_dim=self.qk_rope_dim, v_head_dim=self.v_head_dim)

    def ssm_cfg(self) -> S.SSMConfig:
        return S.SSMConfig(d_model=self.d_model, d_state=self.ssm_state,
                           head_dim=self.ssm_head_dim, chunk=self.ssm_chunk)


def ffn_init(gen, d: int, d_ff: int, *, device, dtype=torch.float32):
    return {"w_gate": L.dense_init(gen, d, d_ff, device=device, dtype=dtype),
            "w_up": L.dense_init(gen, d, d_ff, device=device, dtype=dtype),
            "w_down": L.dense_init(gen, d_ff, d, device=device, dtype=dtype)}


def ffn_apply(p, x: torch.Tensor, sp_cfg, d_ff: int) -> torch.Tensor:
    """SwiGLU FFN.  Inside a ``sharding.tp.model_split`` (``d_ff`` the
    whole hidden width) w_gate and w_up run on the rank's columns of the
    hidden, w_down on its rows, summed over "model"."""
    split = tp.current()
    cols = (0, d_ff) if split is None else split.held(
        L.local_dims(p["w_down"]["w"])[0], d_ff)
    h = L.swiglu(
        L.column_apply(p["w_gate"], x, "mlp/w_gate", sp_cfg, d_ff, cols),
        L.column_apply(p["w_up"], x, "mlp/w_up", sp_cfg, d_ff, cols))
    return L.row_apply(p["w_down"], h.to(x.dtype), "mlp/w_down", sp_cfg,
                       d_ff, cols)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def block_init(gen, cfg: LMConfig, *, device, dtype=torch.float32):
    """A block's params: norms, attention (any attention or hybrid
    layer in the config), an SSD block ("ssm": any mamba or hybrid
    layer), and a dense FFN ("ffn", with ``d_ff``) or, with ``cfg.moe``,
    a mixture of experts ("moe"); every block has the same leaves, as
    the reference's stacked ones.  mamba2's blocks hold ln2 too, which
    no op reads (the reference's)."""
    p = {"ln1": L.rmsnorm_init(cfg.d_model, device=device, dtype=dtype),
         "ln2": L.rmsnorm_init(cfg.d_model, device=device, dtype=dtype)}
    if cfg.has_attn:
        p["attn"] = A.attn_init(gen, cfg.attn_cfg(), device=device,
                                dtype=dtype)
    if cfg.has_ssm:
        p["ssm"] = S.ssm_init(gen, cfg.ssm_cfg(), device=device, dtype=dtype)
    if cfg.moe is not None:
        p["moe"] = M.moe_init(gen, cfg.d_model, cfg.moe, device=device,
                              dtype=dtype)
    elif cfg.d_ff:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, device=device,
                            dtype=dtype)
    return p


def block_apply(p, x: torch.Tensor, cfg: LMConfig, sp_cfg, *, positions,
                kind: str = "attn", window=None, cache=None,
                decode: bool = False, per_slot: bool = True):
    """Returns (x, cache, aux) of a layer of ``kind``; ``window`` is the
    layer's sliding window (None: global attention); ``aux`` is the MoE
    load-balance loss (None for a dense FFN or none).

    A mamba layer adds the SSD block's output to x and nothing else (the
    reference adds zeros for its missing FFN; ln2 gets no gradient); a
    hybrid layer runs attention and the SSD block on the same ln1 output,
    each with its part of one cache dict ({"k", "v", "pos"} and
    {"state", "conv"}), and takes mix = 0.5 (a + s).

    ln2 normalizes the fp32 sum x + mix, not its bf16 rounding: the
    compiled reference fuses the residual add into the norm and keeps
    the sum in fp32 there (the residual stream itself is rounded).
    """
    h = L.rmsnorm_apply(p["ln1"], x)
    if kind == "mamba":
        mix, cache = S.ssm_apply(p["ssm"], h, cfg.ssm_cfg(), sp_cfg,
                                 cache=cache, decode=decode)
        return x + mix, cache, None
    mix, cache = A.attn_apply(p["attn"], h, cfg.attn_cfg(), sp_cfg,
                              positions=positions, cache=cache,
                              layer_window=window, decode=decode,
                              per_slot=per_slot)
    if kind == "hybrid":
        s_out, cache = S.ssm_apply(p["ssm"], h, cfg.ssm_cfg(), sp_cfg,
                                   cache=cache, decode=decode)
        mix = 0.5 * (mix + s_out)
    h2 = L.rmsnorm_apply(p["ln2"], x.to(torch.float32) + mix,
                         out_dtype=x.dtype)
    x = x + mix
    if "moe" in p:
        y, aux = M.moe_apply(p["moe"], h2, cfg.moe, sp_cfg)
    else:
        y, aux = ffn_apply(p["ffn"], h2, sp_cfg, cfg.d_ff), None
    return x + y, cache, aux


def init_shell(cfg: LMConfig, gen: torch.Generator, *, device,
               dtype=torch.float32):
    """Everything but the blocks: embed, the prelude (a config with
    ``first_dense_ff``), final norm and, untied, lm_head."""
    shell = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                   device=device, dtype=dtype)}
    if cfg.uses_scan_prelude:   # a block with a dense FFN of that width
        shell["prelude"] = block_init(
            gen, dataclasses.replace(cfg, moe=None, d_ff=cfg.first_dense_ff),
            device=device, dtype=dtype)
    shell["final_norm"] = L.rmsnorm_init(cfg.d_model, device=device,
                                         dtype=dtype)
    if not cfg.tie_embed:
        shell["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                        device=device, dtype=dtype)
    return shell


def iter_blocks(cfg: LMConfig, gen: torch.Generator, *, device,
                dtype=torch.float32):
    """The per-layer block params, drawn one layer at a time."""
    for _ in range(cfg.n_blocks):
        yield block_init(gen, cfg, device=device, dtype=dtype)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def init(cfg: LMConfig, *, seed: int = 0, device=None, dtype=torch.float32):
    """Random params: ``init_shell`` then ``iter_blocks`` from one
    generator seeded with ``seed``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    params = init_shell(cfg, gen, device=device, dtype=dtype)
    params["blocks"] = list(iter_blocks(cfg, gen, device=device, dtype=dtype))
    return params


def abstract_params(cfg: LMConfig):
    """The param tree's shapes on the meta device, nothing allocated:
    with ``init_specs``, the reference's ``init(..., abstract=True)``."""
    params = init_shell(cfg, None, device="meta")
    params["blocks"] = [block_init(None, cfg, device="meta")
                        for _ in range(cfg.n_blocks)]
    return params


def init_specs(cfg: LMConfig):
    """The logical-axis spec of every leaf of ``init(cfg)``
    (``layers.leaf_spec``): the reference's spec tuples, a per-layer
    leaf's without the leading "layer" of the reference's stacked one
    (``sharding.rules.TRAIN_RULES`` never shards it)."""
    return L.spec_tree(abstract_params(cfg))


def forward(params, tokens: torch.Tensor, cfg: LMConfig,
            sp_cfg: SparsityConfig = DENSE, *, prefix_embeds=None,
            cache=None, decode: bool = False, positions=None,
            per_slot: bool = True):
    """Returns (hidden (B, S, d), cache, aux): ``aux`` is the MoE
    load-balance loss summed over layers (fp32, 0 for a dense model).

    ``prefix_embeds`` (B, S_pre, d): stub-frontend embeddings put before
    the token embeddings (internvl2's vision prefix), cast to their
    dtype.  Decode is per-slot (positions (B, 1) gives each row its own
    position) unless ``per_slot=False``, where every row writes at the
    cache's shared cursor.

    With ``cfg.remat``, a forward without a cache under autograd (a
    training step) runs each block under ``torch.utils.checkpoint``: only
    the block's input is kept, and the block runs again in the backward
    pass, as the reference's ``jax.checkpoint`` with
    ``nothing_saveable`` does.  A prelude runs first, with its own cache
    (``cache["prelude"]``), and is never recomputed, as in the reference.
    """
    x = L.embed_apply(params["embed"], tokens, rows=cfg.padded_vocab)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    layer_caches = cache["layers"] if cache is not None else None
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = None
    if cfg.uses_scan_prelude:
        x, _, _ = block_apply(L.gathered(params["prelude"]), x, cfg, sp_cfg,
                              positions=positions,
                              cache=None if cache is None
                              else cache["prelude"],
                              decode=decode, per_slot=per_slot)
    for i, (bp, kind) in enumerate(zip(params["blocks"],
                                       cfg.block_kinds())):
        window = cfg.layer_window(kind)
        if remat:
            x, a = checkpoint(_block_out, bp, x, cfg, sp_cfg, positions,
                              kind, window, use_reentrant=False)
        else:
            lc = layer_caches[i] if layer_caches is not None else None
            x, _, a = block_apply(L.gathered(bp), x, cfg, sp_cfg,
                                  positions=positions,
                                  kind=kind, window=window, cache=lc,
                                  decode=decode, per_slot=per_slot)
        if a is not None:
            aux = a if aux is None else aux + a
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.rmsnorm_apply(params["final_norm"], x)
    return x, cache, aux


def _block_out(p, x, cfg, sp_cfg, positions, kind, window):
    x, _, aux = block_apply(L.gathered(p), x, cfg, sp_cfg,
                            positions=positions,
                            kind=kind, window=window)
    return x, aux


def logits_from_hidden(params, hidden: torch.Tensor,
                       cfg: LMConfig) -> torch.Tensor:
    """hidden @ lm_head (tied: @ the embedding table's transpose) with
    fp32 accumulation; padded columns -1e30.  A tied table gets its
    gradient from both uses.  Inside a ``sharding.tp.model_split`` the
    rank's vocab block of the logits is gathered whole over "model"."""
    w = (params["embed"]["embed_table"].t() if cfg.tie_embed
         else params["lm_head"]["w"])
    logits = L.head_product(hidden.reshape(-1, hidden.shape[-1]), w)
    logits = logits.reshape(*hidden.shape[:-1], w.shape[-1])
    split = tp.current()
    if split is not None:
        logits = tp.take(logits, split.held(w.shape[-1], cfg.padded_vocab),
                           (0, cfg.padded_vocab), cfg.padded_vocab, split)
    if cfg.padded_vocab != cfg.vocab:
        valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(valid, logits, -1e30)
    return logits


def lm_loss(params, hidden: torch.Tensor, labels: torch.Tensor,
            cfg: LMConfig, *, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy, from fp32 logits taken ``chunk``
    positions at a time, so that (B, S, V) never exists at once; padded
    vocab columns are -1e30 and drop out.  (The reference's per-token
    ``mask`` has no caller here and is not ported.)"""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} not divisible by chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s, chunk):
        logits = logits_from_hidden(params, hidden[:, c:c + chunk], cfg)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c:c + chunk, None].long())
        tot = tot + (logz - gold[..., 0]).sum()
    return tot / (b * s)


def init_lm_cache(cfg: LMConfig, batch: int, max_len: int, *, device,
                  dtype=torch.bfloat16):
    """``{"layers": [one cache a block]}``, and with a prelude its cache
    under ``"prelude"``.  An attention layer's cache is (k, v, pos) in
    ``dtype`` (MLA: ckv, kpe, pos); a mamba layer's the fp32 SSM state
    and conv window; a hybrid layer's both, in one dict."""
    def one(kind="attn"):
        c = {}
        if kind in ("attn", "swa", "hybrid"):
            c.update(A.init_cache(cfg.attn_cfg(), batch, max_len,
                                  device=device, dtype=dtype))
        if kind in ("mamba", "hybrid"):
            c.update(S.init_ssm_cache(cfg.ssm_cfg(), batch, device=device))
        return c

    cache = {"layers": [one(k) for k in cfg.block_kinds()]}
    if cfg.uses_scan_prelude:
        cache["prelude"] = one()
    return cache
