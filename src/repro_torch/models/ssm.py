"""Mamba-2 (SSD, state-space duality) block: prefill, training and
single-step decode.

Counterpart of ``src/repro/models/ssm.py``: ``SSMConfig``, ``ssm_init``,
``_causal_conv`` (the short depthwise causal conv over (x, B, C)),
``_ssd_chunked`` (the chunked scan: a quadratic term within each chunk
of ``chunk`` positions and a recurrent state passed across chunks),
``ssm_apply`` (prefill with and without a cache, and decode) and
``init_ssm_cache``, with the reference's arithmetic:

  * ``in_proj`` is split into z, x, B, C, dt in that order; the conv
    runs over concat(x, B, C) and is split again;
  * ``dt = softplus(dt + dt_bias)`` in fp32 (softplus spelled as the
    reference's ``logaddexp(x, 0)``), ``A = -exp(A_log)`` in A_log's
    dtype (bf16 on a pre-generated compute tree), the conv a sum of K
    products in the activation dtype, in tap order;
  * the SSD products take bf16-rounded operands and keep fp32 sums
    (the reference's ``preferred_element_type=float32``); here they are
    fp32 einsums of the rounded values at full fp32 precision (TF32 off
    for their span), with the reference's pairwise order for its
    three-operand einsums: the two operands without the contracted
    state axis first (an exact product in fp32), then the contraction;
  * SiLU is spelled out with every op rounded to the activation dtype
    (``layers.silu``), as the compiled reference expands it, and the
    output gate's product y * silu(z) reaches ``ssm_norm`` in fp32,
    unrounded, as the compiled reference fuses it into the norm (the
    eager reference rounds it to bf16 first);
  * the caches are fp32 (``init_ssm_cache``), beside bf16 attention
    caches; prefill ignores an incoming conv state, decode shifts it.

What differs: the chunk recurrence is a Python loop, not a scan, and
the caches are written in place (the reference returns new arrays);
``ssm_init`` draws from an explicit ``torch.Generator`` on an explicit
device.  The deterministic leaves are the reference's: ``A_log`` is the
log of the reference's linspace (XLA's rewrite of it, bitwise; the log
within an ulp, as two libms give it), ``D = 1`` and ``dt_bias =
log(expm1(0.01))``.  A sequence that the chunk does not divide is
refused with an error, as the reference asserts, never padded.

The profiler ranges ``ssm/conv`` (in_proj's split, dt and the conv),
``ssm/scan`` (the SSD scan or the decode recurrence) and ``ssm/out``
(the gate, the norm and out_proj) split the block's time.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from repro_torch.models import layers as L
from repro_torch.models.attention import _full_fp32_matmuls


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state

    @property
    def d_in_proj(self) -> int:
        """in_proj's width: z, x, B, C and dt."""
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads


def _linspace_1_16(n: int, device) -> torch.Tensor:
    """The reference's ``jnp.linspace(1, 16, n)`` in fp32, as XLA
    computes it: r = 1/(n-1) and c = 16 r rounded to fp32, then
    fma(i, c, 1 - i r) (one rounding, here in fp64), and 16 last."""
    if n == 1:
        return torch.ones((1,), dtype=torch.float32, device=device)
    div = n - 1
    r = torch.tensor(1.0, dtype=torch.float32) / div
    c = (16.0 * r).to(torch.float64)
    i = torch.arange(div, dtype=torch.float32, device=device)
    a = 1.0 - i * r.to(device)
    out = (i.to(torch.float64) * c.to(device) + a.to(torch.float64))
    return torch.cat([out.to(torch.float32),
                      torch.full((1,), 16.0, dtype=torch.float32,
                                 device=device)])


def ssm_init(gen: torch.Generator, cfg: SSMConfig, *, device,
             dtype=torch.float32):
    """in_proj (d, 2 di + 2 N + H) ~ N(0, 1) d**-0.5, out_proj (di, d) ~
    N(0, 1) di**-0.5, conv_w (K, C) ~ N(0, 1) 0.3, drawn in that order in
    fp32; A_log, D, dt_bias and ssm_norm deterministic."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * scale

    p = {"in_proj": {"w": randn((d, cfg.d_in_proj), d ** -0.5)},
         "out_proj": {"w": randn((di, d), di ** -0.5)},
         "conv_w": randn((cfg.d_conv, cfg.conv_dim), 0.3),
         "A_log": torch.log(_linspace_1_16(nh, device)),
         "D": torch.ones((nh,), dtype=torch.float32, device=device),
         "dt_bias": torch.log(torch.expm1(torch.full(
             (nh,), 0.01, dtype=torch.float32, device=device))),
         "ssm_norm": L.rmsnorm_init(di, device=device)}
    return {k: ({kk: vv.to(dtype) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(dtype))
            for k, v in p.items()}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, conv_state=None):
    """Depthwise causal conv1d and its SiLU.  xbc: (B, S, C); conv_w:
    (K, C); conv_state (B, K-1, C) or None (zeros).  Returns (silu(out),
    the last K-1 input rows), both in xbc's dtype."""
    k, s = conv_w.shape[0], xbc.shape[1]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    w = conv_w.to(xbc.dtype)
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return L.silu(out), xp[:, -(k - 1):]


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, as fp32 (an einsum operand of the reference)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _ssd_chunked(x, dt, A, Bmat, Cmat, D, chunk: int):
    """The chunked SSD scan.  x: (B, S, H, P) fp32; dt: (B, S, H) fp32;
    A: (H,) negative decay rates; Bmat/Cmat: (B, S, N) fp32; D: (H,).
    Returns (y (B, S, H, P) fp32, the state after the last chunk
    (B, H, N, P) fp32)."""
    b, s, h, pdim = x.shape
    n = Bmat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} not divisible by the SSD chunk "
                         f"{chunk}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, pdim)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = _bf16_f32(Bmat.reshape(b, nc, chunk, n))
    cc = _bf16_f32(Cmat.reshape(b, nc, chunk, n))

    dA = dtc * A                                   # (B, nc, L, H), fp32
    cum = torch.cumsum(dA, dim=2)
    with _full_fp32_matmuls():
        # within a chunk: decay(t, s) = exp(cum_t - cum_s) for t >= s
        mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                     device=x.device))
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                      float("-inf")))
        cb = torch.einsum("bzln,bzmn->bzlm", cc, bc)
        att = _bf16_f32(cb[..., None] * decay)     # (B, nc, L, L, H)
        del decay, diff
        dtx = _bf16_f32(dtc[..., None] * xc)       # (B, nc, L, H, P)
        y = torch.einsum("bzlmh,bzmhp->bzlhp", att, dtx)
        del att
        # each chunk's state contribution: sum_s exp(cum_L - cum_s) dt_s
        # B_s x_s; (tail x B) first, an exact product of bf16 values
        tail = _bf16_f32(torch.exp(cum[:, :, -1:, :] - cum))
        states = torch.einsum("bzlhn,bzlhp->bzhnp",
                              tail[..., None] * bc[:, :, :, None, :], dtx)
        chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
        state = torch.zeros((b, h, n, pdim), dtype=x.dtype, device=x.device)
        h_in = []                                  # the state entering
        for z in range(nc):
            h_in.append(state)
            state = state * chunk_decay[:, z, :, None, None] + states[:, z]
        h_in = _bf16_f32(torch.stack(h_in, dim=1))  # (B, nc, H, N, P)
        # across chunks: y_t += C_t exp(cum_t) h_in, (exp(cum) x C) first
        inter = _bf16_f32(torch.exp(cum))
        y = y + torch.einsum("bzlhn,bzhnp->bzlhp",
                             inter[..., None] * cc[:, :, :, None, :], h_in)
    y = y.reshape(b, s, h, pdim)
    return y + x * D.to(torch.float32)[None, None, :, None], state


def ssm_apply(p, x: torch.Tensor, cfg: SSMConfig, sp_cfg, *, cache=None,
              decode: bool = False):
    """x: (B, S, d) -> ((B, S, d), cache).  ``cache`` {"state" (B, H, N,
    P), "conv" (B, K-1, C)} is written in place and returned: by a
    prefill with the state after its last position and its last K-1 conv
    inputs (an incoming conv state is ignored), by decode (S = 1) with
    the next state and the shifted conv window."""
    b, s, _ = x.shape
    di, st, nh, pdim = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    with record_function("ssm/conv"):
        proj = L.dense_apply(p["in_proj"], x, "ssm/in_proj", sp_cfg)
        z, xin, bmat, cmat, dt = torch.split(proj, [di, di, st, st, nh],
                                             dim=-1)
        dt = softplus(dt.to(torch.float32) + p["dt_bias"])     # (B, S, H)
        A = -torch.exp(p["A_log"])
        conv_in = torch.cat([xin, bmat, cmat], dim=-1)
        conv_out, new_conv = _causal_conv(
            conv_in, p["conv_w"], cache["conv"] if decode else None)
        xin, bmat, cmat = torch.split(conv_out, [di, st, st], dim=-1)
        xh = xin.reshape(b, s, nh, pdim).to(torch.float32)
        bmat = bmat.to(torch.float32)
        cmat = cmat.to(torch.float32)

    with record_function("ssm/scan"):
        if decode:
            if cache is None or s != 1:
                raise ValueError("SSM decode needs a cache and one token")
            h_prev = cache["state"].to(torch.float32)
            dt1 = dt[:, 0]                                     # (B, H)
            da = torch.exp(dt1 * A.to(torch.float32)[None, :])
            # (dt x) first, then B: the reference's pairwise order
            upd = ((dt1[:, :, None] * xh[:, 0])[:, :, None, :]
                   * bmat[:, 0][:, None, :, None])             # (B,H,N,P)
            h_new = h_prev * da[..., None, None] + upd
            with _full_fp32_matmuls():
                y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], h_new)
            y = y + xh[:, 0] * p["D"].to(torch.float32)[None, :, None]
            y = y.reshape(b, 1, di)
            cache["state"].copy_(h_new)
            cache["conv"].copy_(new_conv)
        else:
            y4, h_last = _ssd_chunked(xh, dt, A, bmat, cmat, p["D"],
                                      cfg.chunk)
            y = y4.reshape(b, s, di)
            if cache is not None:
                cache["state"].copy_(h_last)
                cache["conv"].copy_(new_conv)

    with record_function("ssm/out"):
        # the gate's product (exact in fp32) reaches the norm unrounded:
        # the compiled reference fuses it into the norm in fp32
        y = y.to(x.dtype).to(torch.float32) * L.silu(z).to(torch.float32)
        y = L.rmsnorm_apply(p["ssm_norm"], y, out_dtype=x.dtype)
        return L.dense_apply(p["out_proj"], y, "ssm/out_proj", sp_cfg), cache


def init_ssm_cache(cfg: SSMConfig, batch: int, *, device,
                   dtype=torch.float32):
    """Zero ``{"state" (B, H, N, P), "conv" (B, K-1, C)}``, fp32 unless
    ``dtype`` says otherwise (the reference calls it without one)."""
    return {"state": torch.zeros((batch, cfg.n_heads, cfg.d_state,
                                  cfg.head_dim), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                                dtype=dtype, device=device)}
