"""The paper's own benchmark models: ResNet9/18/50, VGG19, ViT.

Counterpart of ``src/repro/models/convnets.py``: ``resnet9_init``/
``resnet9_apply``, ``resnet_init``/``resnet_apply`` (ResNet18 and 50),
``vgg19_init``/``vgg19_apply``, ``ViTConfig`` and ``vit_init``/
``vit_apply``, with the helpers ``_bn_apply``, ``_conv_bn_relu``,
``_nm_conv_auto`` and ``_nm_lin``.  Every conv and every ViT linear goes
through ``core.operand.nm_apply`` (a ``MaskedOp`` for a plain weight, a
``PregenOp`` from ``optim.sgd.pregen_tree``), so BDWP applies as in the
paper: every conv but the first (``head0``, excluded by name) and every
linear of the ViT blocks.  Activations are NHWC and conv weights HWIO;
the tree names and shapes are the reference's.

What differs:
  * init draws from an explicit ``torch.Generator`` on an explicit
    device, so the same seed gives other numbers than ``jax.random``
    (parity tests load the reference's weights through ``convert``);
  * ``ImageModel`` names one model and its sizes, and ``init``/``apply``
    dispatch on it (the reference's callers pick the functions);
  * max pooling with XLA's SAME padding pads with -inf first, as the
    convs pad (``operand.conv_pads``);
  * the classifier of a ResNet18/50 tree whose ``fc/w`` was
    pre-generated raises ``TypeError``: that ``fc`` passes
    ``bdwp.should_prune``, and the reference fails there too (it calls
    ``.astype`` on the ``PregenOp``); both train on the legacy dataflow
    (``train.step.image_train_step(pregen=False)``), which hands the
    model its fp32 master.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import operand as O
from repro_torch.core.sparsity import DENSE, SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def _conv_init(gen, kh, kw, cin, cout, device):
    scale = (kh * kw * cin) ** -0.5
    return {"w": torch.randn((kh, kw, cin, cout), generator=gen,
                             device=device, dtype=torch.float32) * scale}


def _bn_init(c, device):
    return {"norm_scale": torch.ones((c,), device=device),
            "norm_bias": torch.zeros((c,), device=device)}


def _dense_init(gen, d_in, d_out, device, scale):
    return torch.randn((d_in, d_out), generator=gen, device=device,
                       dtype=torch.float32) * scale


def _bn_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Norm over (N, H, W) with the batch's fp32 mean and population
    variance, cast back to x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean((0, 1, 2), keepdim=True)
    var = xf.var((0, 1, 2), keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + 1e-5) * p["norm_scale"] \
        + p["norm_bias"]
    return out.to(x.dtype)


def _nm_conv_auto(leaf, x, sp_cfg, name, stride=1, padding="SAME"):
    """Conv through ``operand.nm_apply``: a pre-generated leaf consumes
    its stored FF/BP operands; a plain weight (pass the fp32 master)
    takes the in-op masking ``MaskedOp`` route."""
    op = O.as_operand(leaf["w"], name, sp_cfg)
    return O.nm_apply(op, x, stride=stride, padding=padding)


def _conv_bn_relu(p, x, sp_cfg, name, stride=1):
    y = _nm_conv_auto(p["conv"], x, sp_cfg, name, stride)
    return torch.relu(_bn_apply(p["bn"], y))


def _max_pool(x: torch.Tensor, window: int, stride: int,
              padding: str = "VALID") -> torch.Tensor:
    """``lax.reduce_window`` max over H and W of NHWC x; SAME pads with
    -inf the way XLA does."""
    (hl, hh), (wl, wh) = O.conv_pads(x.shape, (window, window), stride,
                                     padding)
    if hl or hh or wl or wh:
        x = F.pad(x, (0, 0, wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(
        0, 2, 3, 1)


def _spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, summed in fp32 and cast back (``jnp.mean``)."""
    return x.to(torch.float32).mean((1, 2)).to(x.dtype)


def _classifier(w, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of x @ w; a pre-generated ``w`` is refused, as the
    reference fails on it."""
    if isinstance(w, O.SparseOperand):
        raise TypeError(
            f"the classifier weight is a {type(w).__name__}: this model's "
            "fc passes should_prune, so pregen_tree made it an operand "
            "that the reference cannot consume either (ROADMAP queue 3); "
            "train it on the MaskedOp path (pregen=False)")
    return L.head_product(x, w)


# ---------------------------------------------------------------------------
# ResNet9 (DAWNBench-style, CIFAR)
# ---------------------------------------------------------------------------


def resnet9_init(gen: torch.Generator, num_classes: int = 10,
                 width: int = 64, *, device):
    w = width

    def cb(cin, cout):
        return {"conv": _conv_init(gen, 3, 3, cin, cout, device),
                "bn": _bn_init(cout, device)}

    return {
        "head0": cb(3, w),
        "conv1": cb(w, 2 * w),
        "res1a": cb(2 * w, 2 * w),
        "res1b": cb(2 * w, 2 * w),
        "conv2": cb(2 * w, 4 * w),
        "conv3": cb(4 * w, 8 * w),
        "res2a": cb(8 * w, 8 * w),
        "res2b": cb(8 * w, 8 * w),
        "fc": {"w": _dense_init(gen, 8 * w, num_classes, device,
                                (8 * w) ** -0.5)},
    }


def resnet9_apply(p, x, sp_cfg: SparsityConfig = DENSE):
    x = _conv_bn_relu(p["head0"], x, sp_cfg, "head0")
    x = _conv_bn_relu(p["conv1"], x, sp_cfg, "conv1")
    x = _max_pool(x, 2, 2)
    r = _conv_bn_relu(p["res1a"], x, sp_cfg, "res1a")
    r = _conv_bn_relu(p["res1b"], r, sp_cfg, "res1b")
    x = x + r
    x = _conv_bn_relu(p["conv2"], x, sp_cfg, "conv2")
    x = _max_pool(x, 2, 2)
    x = _conv_bn_relu(p["conv3"], x, sp_cfg, "conv3")
    x = _max_pool(x, 2, 2)
    r = _conv_bn_relu(p["res2a"], x, sp_cfg, "res2a")
    r = _conv_bn_relu(p["res2b"], r, sp_cfg, "res2b")
    x = x + r
    x = x.amax((1, 2))  # global max pool
    return _classifier(p["fc"]["w"], x)


# ---------------------------------------------------------------------------
# ResNet18 / ResNet50 (standard He et al.)
# ---------------------------------------------------------------------------

_RESNET_STAGES = {
    18: ([2, 2, 2, 2], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
}


def resnet_init(gen: torch.Generator, depth: int, num_classes: int = 1000,
                width: int = 64, *, device):
    stages, kind = _RESNET_STAGES[depth]

    def cb(kh, cin, cout):
        return {"conv": _conv_init(gen, kh, kh, cin, cout, device),
                "bn": _bn_init(cout, device)}

    p = {"head0": cb(7, 3, width)}
    cin = width
    for si, n_blocks in enumerate(stages):
        cout = width * (2 ** si)
        cexp = cout * (4 if kind == "bottleneck" else 1)
        for bi in range(n_blocks):
            blk = {}
            if kind == "basic":
                blk["c1"] = cb(3, cin, cout)
                blk["c2"] = cb(3, cout, cout)
            else:
                blk["c1"] = cb(1, cin, cout)
                blk["c2"] = cb(3, cout, cout)
                blk["c3"] = cb(1, cout, cexp)
            if bi == 0 and cin != cexp:
                blk["proj"] = cb(1, cin, cexp)
            p[f"s{si}b{bi}"] = blk
            cin = cexp
    p["fc"] = {"w": _dense_init(gen, cin, num_classes, device, cin ** -0.5)}
    p["_meta"] = torch.tensor([depth], dtype=torch.int32, device=device)
    return p


def resnet_apply(p, x, depth: int, sp_cfg: SparsityConfig = DENSE,
                 width: int = 64):
    stages, kind = _RESNET_STAGES[depth]
    x = _conv_bn_relu(p["head0"], x, sp_cfg, "head0", stride=2)
    x = _max_pool(x, 3, 2, "SAME")
    for si, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            blk = p[name]
            stride = 2 if (bi == 0 and si > 0) else 1
            sc = x
            if "proj" in blk:
                sc = _nm_conv_auto(blk["proj"]["conv"], x, sp_cfg,
                                   f"{name}/proj", stride)
                sc = _bn_apply(blk["proj"]["bn"], sc)
            if kind == "basic":
                y = _conv_bn_relu(blk["c1"], x, sp_cfg, f"{name}/c1", stride)
                y = _nm_conv_auto(blk["c2"]["conv"], y, sp_cfg,
                                  f"{name}/c2", 1)
                y = _bn_apply(blk["c2"]["bn"], y)
            else:
                y = _conv_bn_relu(blk["c1"], x, sp_cfg, f"{name}/c1", 1)
                y = _conv_bn_relu(blk["c2"], y, sp_cfg, f"{name}/c2", stride)
                y = _nm_conv_auto(blk["c3"]["conv"], y, sp_cfg,
                                  f"{name}/c3", 1)
                y = _bn_apply(blk["c3"]["bn"], y)
            x = torch.relu(sc + y)
    return _classifier(p["fc"]["w"], _spatial_mean(x))


# ---------------------------------------------------------------------------
# VGG19
# ---------------------------------------------------------------------------

_VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg19_init(gen: torch.Generator, num_classes: int = 100, *, device):
    p = {}
    cin = 3
    for i, v in enumerate(_VGG19):
        if v == "M":
            continue
        name = "head0" if cin == 3 else f"conv{i}"
        p[name] = {"conv": _conv_init(gen, 3, 3, cin, v, device),
                   "bn": _bn_init(v, device)}
        cin = v
    p["fc"] = {"w": _dense_init(gen, 512, num_classes, device, 512 ** -0.5)}
    return p


def vgg19_apply(p, x, sp_cfg: SparsityConfig = DENSE):
    cin = 3
    for i, v in enumerate(_VGG19):
        if v == "M":
            x = _max_pool(x, 2, 2)
            continue
        name = "head0" if cin == 3 else f"conv{i}"
        x = _conv_bn_relu(p[name], x, sp_cfg, name)
        cin = v
    return _classifier(p["fc"]["w"], _spatial_mean(x))


# ---------------------------------------------------------------------------
# ViT (CIFAR-scale, the paper's transformer benchmark)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image: int = 32
    patch: int = 4
    d_model: int = 384
    n_layers: int = 7
    n_heads: int = 6
    d_ff: int = 1536
    num_classes: int = 100


def vit_init(gen: torch.Generator, cfg: ViTConfig, *, device):
    n_patch = (cfg.image // cfg.patch) ** 2
    pdim = cfg.patch * cfg.patch * 3
    d = cfg.d_model
    p = {
        "patch_frontend": {"w": _dense_init(gen, pdim, d, device,
                                            pdim ** -0.5)},
        "pos_embed": torch.randn((n_patch + 1, d), generator=gen,
                                 device=device) * 0.02,
        "cls_embed": torch.zeros((d,), device=device),
        "head": {"w": _dense_init(gen, d, cfg.num_classes, device,
                                  d ** -0.5)},
    }
    for i in range(cfg.n_layers):
        blk = {"ln1": L.layernorm_init(d, device=device),
               "ln2": L.layernorm_init(d, device=device)}
        for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
            blk[nm] = {"w": _dense_init(gen, d, d, device, d ** -0.5)}
        blk["w_in"] = {"w": _dense_init(gen, d, cfg.d_ff, device,
                                        d ** -0.5)}
        blk["w_out"] = {"w": _dense_init(gen, cfg.d_ff, d, device,
                                         cfg.d_ff ** -0.5)}
        p[f"block{i}"] = blk
    return p


def _nm_lin(leaf, x, name, sp_cfg):
    """ViT linear through ``operand.nm_apply`` (weight or PregenOp)."""
    return O.nm_apply(O.as_operand(leaf["w"], name, sp_cfg), x)


def _attention(q, k, v, n_heads: int) -> torch.Tensor:
    """Softmax attention of (B, S, D) q/k/v over ``n_heads`` heads: fp32
    logits of the bf16 values scaled by head_dim**-0.5, an fp32 softmax
    cast to v's dtype, then an fp32-accumulated product rounded once."""
    b, s, d = q.shape
    hd = d // n_heads
    q, k, v = (t.reshape(b, s, n_heads, hd) for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", attn.to(torch.float32),
                     v.to(torch.float32))
    return o.to(v.dtype).reshape(b, s, d)


def vit_apply(p, x, cfg: ViTConfig, sp_cfg: SparsityConfig = DENSE):
    b = x.shape[0]
    s = cfg.image // cfg.patch
    x = x.reshape(b, s, cfg.patch, s, cfg.patch, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, s * s, -1).to(torch.bfloat16)
    # patch embedding = the "first layer" -> excluded from pruning by name
    x = _nm_lin(p["patch_frontend"], x, "patch_frontend", sp_cfg)
    cls = p["cls_embed"].to(x.dtype).expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + p["pos_embed"].to(x.dtype)
    for i in range(cfg.n_layers):
        blk = p[f"block{i}"]
        h = L.layernorm_apply(blk["ln1"], x)
        q = _nm_lin(blk["q_proj"], h, "attn/q_proj", sp_cfg)
        k = _nm_lin(blk["k_proj"], h, "attn/k_proj", sp_cfg)
        v = _nm_lin(blk["v_proj"], h, "attn/v_proj", sp_cfg)
        o = _nm_lin(blk["o_proj"], _attention(q, k, v, cfg.n_heads),
                    "attn/o_proj", sp_cfg)
        x = x + o
        h2 = L.layernorm_apply(blk["ln2"], x)
        f = L.gelu_tanh(_nm_lin(blk["w_in"], h2, "mlp/w_in", sp_cfg))
        x = x + _nm_lin(blk["w_out"], f.to(x.dtype), "mlp/w_out", sp_cfg)
    return _classifier(p["head"]["w"], x[:, 0])


# ---------------------------------------------------------------------------
# One entry point for the five models
# ---------------------------------------------------------------------------

MODELS = ("resnet9", "resnet18", "resnet50", "vgg19", "vit")


@dataclasses.dataclass(frozen=True)
class ImageModel:
    """One of ``MODELS`` at given sizes: ``num_classes``, the base channel
    ``width`` of a ResNet (VGG19 has none), and ``vit`` the config of the
    ViT, whose ``num_classes`` must agree."""

    name: str
    num_classes: int
    width: int = 64
    vit: Optional[ViTConfig] = None

    def __post_init__(self):
        if self.name not in MODELS:
            raise ValueError(f"unknown model {self.name!r}; one of {MODELS}")
        if (self.name == "vit") != (self.vit is not None):
            raise ValueError("a ViTConfig goes with the vit model only")
        if self.vit is not None and self.vit.num_classes != self.num_classes:
            raise ValueError(f"num_classes {self.num_classes} != the ViT's "
                             f"{self.vit.num_classes}")


def init(model: ImageModel, *, seed: int = 0, device=None):
    """Random fp32 params of ``model`` from a generator seeded with
    ``seed`` on ``device`` (the card unless another is named)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if model.name == "resnet9":
        return resnet9_init(gen, model.num_classes, model.width,
                            device=device)
    if model.name == "vgg19":
        return vgg19_init(gen, model.num_classes, device=device)
    if model.name == "vit":
        return vit_init(gen, model.vit, device=device)
    return resnet_init(gen, int(model.name[len("resnet"):]),
                       model.num_classes, model.width, device=device)


def apply(model: ImageModel, p, x: torch.Tensor,
          sp_cfg: SparsityConfig = DENSE) -> torch.Tensor:
    """fp32 logits (B, num_classes) of NHWC images x."""
    if model.name == "resnet9":
        return resnet9_apply(p, x, sp_cfg)
    if model.name == "vgg19":
        return vgg19_apply(p, x, sp_cfg)
    if model.name == "vit":
        return vit_apply(p, x, model.vit, sp_cfg)
    return resnet_apply(p, x, int(model.name[len("resnet"):]), sp_cfg,
                        model.width)


def image_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy ``logsumexp(logits) - logits[label]`` (the
    reference's ``examples/paper_loss_curves.py``)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (logz - gold).mean()
