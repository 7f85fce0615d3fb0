"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared experts.

Counterpart of ``src/repro/models/moe.py``: ``MoEConfig``, ``moe_init``,
``_slot_gather``, ``_nm_mm``, ``_expert_ffn`` and ``moe_apply`` with the
reference's routing (GShard-style groups of ``group_size`` tokens, a
per-group capacity, top-k by probability, slots filled in token order)
and arithmetic (fp32 router logits and softmax, the gates renormalised
over the top k and cast to the activation dtype for the combine, the
Switch load-balance aux loss from the kept assignments).  The expert
stacks (E, K, F) are bare leaves consumed through ``operand.nm_apply``
(the rank says they are stacked): N:M groups stay within one expert,
and a packed pre-generated stack runs all experts in one ``nm_spmm``
launch.  The
router is dense (excluded by name).

What differs:
  * the reference's activation-sharding constraints (``act``) are
    no-ops without a mesh and are left out;
  * ``moe_init`` draws from a ``torch.Generator`` on an explicit device;
  * the dispatch gathers each expert's rows straight into the (E, G*C, d)
    layout the experts read (the reference gathers (G, E, C, d) and
    transposes), and the combine reads the experts' output in place;
  * ``top_k`` is a stable descending sort (the lower expert wins a tie,
    as ``jax.lax.top_k``), the softmax is spelled exp(x - max) / sum as
    ``jax.nn.softmax``;
  * the combine multiplies and sums in fp32 and rounds once: the
    compiled reference computes ``(y_k * bf16(gate)).sum(2)`` so (a
    bitwise probe of the jitted expression on the CPU: the bf16 product
    is never rounded), not as its source's bf16 product reads;
  * routing, dispatch, experts and combine run under the profiler
    ranges ``moe/route``, ``moe/dispatch``, ``moe/experts`` and
    ``moe/combine``;
  * the reference is one SPMD program over the whole batch; a port rank
    holds its row block of it, and under ``layers.token_split`` (the
    sharded training step) it routes in the whole batch's groups (a
    group that spans ranks continues the queues of the ranks ahead,
    ``_split_groups``) and sums the aux loss's probabilities and kept
    counts over the ranks, in rank order.
"""

from __future__ import annotations

import dataclasses
import typing

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core import bdwp
from repro_torch.core import operand as O
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int          # per-expert FFN hidden size
    n_shared: int = 0      # always-on shared experts (deepseek-v2 style)
    capacity_factor: float = 1.25
    group_size: int = 512  # routing group (GShard): capacity is per-group


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, *, device,
             dtype=torch.float32):
    """{"router": {"w": (d, E)}, "w_gate"/"w_up": (E, d, d_expert),
    "w_down": (E, d_expert, d)[, "shared": {...}]}, N(0, 1) draws in fp32
    scaled as the reference's."""
    e, dff = cfg.n_experts, cfg.d_expert
    scale = d_model ** -0.5

    def draw(shape, s):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * s).to(dtype)

    p = {"router": {"w": draw((d_model, e), scale)},
         "w_gate": draw((e, d_model, dff), scale),
         "w_up": draw((e, d_model, dff), scale),
         "w_down": draw((e, dff, d_model), dff ** -0.5)}
    if cfg.n_shared:
        sh = cfg.n_shared * dff
        p["shared"] = {"w_gate": draw((d_model, sh), scale),
                       "w_up": draw((d_model, sh), scale),
                       "w_down": draw((sh, d_model), sh ** -0.5)}
    return p


def group_size(t: int, cfg: MoEConfig) -> int:
    """The routing group: ``group_size`` tokens, or the largest divisor
    of ``t`` below it."""
    sg = min(cfg.group_size, t)
    while t % sg:
        sg -= 1
    return sg


def capacity(sg: int, cfg: MoEConfig) -> int:
    """Slots per expert per group: capacity_factor x the even share,
    at least top_k, at most the group (Python's ``round``, half to even,
    as the reference)."""
    cap = int(max(cfg.top_k, round(sg * cfg.capacity_factor * cfg.top_k
                                   / cfg.n_experts)))
    return min(cap, sg)


class Routing(typing.NamedTuple):
    """One routing of (G, S) tokens: fp32 ``probs`` (G, S, E); the top-k
    ``gate_idx`` (G, S, K) and the renormalised ``gates`` (zero where the
    assignment was dropped); each assignment's queue position ``pos`` and
    ``keep`` = pos < cap; ``slot_token`` (G, E, C), the token filling
    each slot (S for an empty one); ``cap``."""
    probs: torch.Tensor
    gate_idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot_token: torch.Tensor
    cap: int


def router_probs(xt: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """fp32 routing probabilities (G, S, E) of xt (G, S, d): the logits
    an fp32 product of the bf16 operands (exact products, fp32 sums, as
    the reference's dot with fp32 accumulation; differentiable, unlike
    the card's bf16 product with fp32 output), softmax spelled
    exp(x - max) / sum."""
    logits = torch.matmul(xt.to(torch.float32),
                          router_w.to(xt.dtype).to(torch.float32))
    z = torch.exp(logits - logits.amax(-1, keepdim=True))
    return z / z.sum(-1, keepdim=True)


def route(probs: torch.Tensor, cfg: MoEConfig, *, cap=None,
          before=None) -> Routing:
    """Route (G, S) tokens by their probabilities: top-k, renormalised
    gates, queue positions in token order, capacity (``cap`` slots an
    expert, by default the group's).  ``before``, for one group (G = 1)
    that is the tail of a longer one: a function of the (E,) count of
    these tokens' assignments to each expert giving each expert's count
    of the assignments queued ahead of them."""
    g, sg, e = probs.shape
    k = cfg.top_k
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_idx = order[..., :k]
    gates = top[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if cap is None:
        cap = capacity(sg, cfg)

    # slot assignment inside each (group, expert) queue, in token order:
    # the count of the expert's earlier assignments, a running sum of the
    # one-hot rows (scanned along the innermost axis: (G, E, S*K))
    flat = F.one_hot(gate_idx.reshape(g, sg * k), e).to(
        torch.int32).transpose(1, 2).contiguous()
    pos = (torch.cumsum(flat, dim=2, dtype=torch.int32) - flat).gather(
        1, gate_idx.reshape(g, 1, sg * k)).reshape(g, sg, k)
    if before is not None:
        pos = pos + before(flat.sum((0, 2), dtype=torch.int32))[gate_idx]
    keep = pos < cap
    gates = gates * keep

    gi = torch.arange(g, device=probs.device)[:, None, None].expand_as(
        gate_idx)
    si = torch.arange(sg, device=probs.device,
                      dtype=torch.int32)[None, :, None].expand_as(gate_idx)
    pos_c = torch.where(keep, pos, cap)          # dropped -> sentinel column
    slot_token = torch.full((g, e, cap + 1), sg, dtype=torch.int32,
                            device=probs.device)
    slot_token[gi, gate_idx, pos_c.long()] = si
    return Routing(probs, gate_idx, gates, pos, keep,
                   slot_token[..., :cap].contiguous(), cap)


def _slot_gather(xt: torch.Tensor, slot_token: torch.Tensor) -> torch.Tensor:
    """The experts' rows (E, G*C, d): row g*C + c of expert e is token
    slot_token[g, e, c] of group g, an empty slot (index S) a zero row.
    The reference's fill-mode gather is a gather from the source with one
    zero row appended to each group."""
    g, sg, d = xt.shape
    src = torch.cat([xt, xt.new_zeros((g, 1, d))], dim=1).reshape(-1, d)
    base = torch.arange(g, device=xt.device, dtype=torch.int32) * (sg + 1)
    rows = (slot_token + base[:, None, None]).permute(1, 0, 2).reshape(-1)
    return src.index_select(0, rows).reshape(slot_token.shape[1], -1, d)


def _nm_mm(leaf, x: torch.Tensor, name: str,
           sp_cfg: SparsityConfig) -> torch.Tensor:
    """One bare-leaf matmul through ``operand.nm_apply``: a pre-generated
    operand as it is, a plain weight as a ``MaskedOp`` that re-derives
    its masks (an expert stack's config picked on one expert's (K, F),
    as the reference's ``stacked`` leaf)."""
    if isinstance(leaf, O.SparseOperand):
        op = leaf
    else:
        op = O.MaskedOp(leaf, bdwp.pick_cfg(name, tuple(leaf.shape[-2:]),
                                            sp_cfg))
    return O.nm_apply(op, x)


def _expert_ffn(w_gate, w_up, w_down, x: torch.Tensor,
                sp_cfg: SparsityConfig) -> torch.Tensor:
    """x (E, C, d) -> (E, C, d): the SwiGLU FFN of every expert."""
    h = L.swiglu(_nm_mm(w_gate, x, "moe/expert/w_gate", sp_cfg),
                 _nm_mm(w_up, x, "moe/expert/w_up", sp_cfg))
    return _nm_mm(w_down, h.to(x.dtype), "moe/expert/w_down", sp_cfg)


def _split_groups(t: int, split, cfg: MoEConfig):
    """(group size here, ``before``, capacity) of this rank's ``t``
    tokens, the ``split.index``-th contiguous block of a batch of ``t x
    split.parts`` tokens, routed in the whole batch's groups: whole
    groups here, or the part of one group that spans several ranks (its
    queues continue those of the ranks ahead of this one).  Raises when
    the whole batch's groups cut this rank's block otherwise."""
    sg = group_size(t * split.parts, cfg)
    if t % sg == 0:
        return sg, None, None
    if sg % t:
        raise ValueError(
            f"MoE routing groups of {sg} tokens over {split.parts} ranks of "
            f"{t} tokens each cut a rank's block: give each rank a multiple "
            "or a divisor of the group")
    first = split.index - split.index % (sg // t)

    def before(counts):
        return split.gather(counts)[first:split.index].sum(
            0, dtype=torch.int32)

    return t, before, capacity(sg, cfg)


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig,
              sp_cfg: SparsityConfig):
    """x (B, S, d) -> ((B, S, d), aux load-balancing loss (fp32 0-d))."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    split = L.current_token_split()
    if split is None:
        sg, before, cap = group_size(t, cfg), None, None
    else:
        sg, before, cap = _split_groups(t, split, cfg)
    g = t // sg
    xt = x.reshape(g, sg, d)

    with record_function("moe/route"):
        r = route(router_probs(xt, p["router"]["w"]), cfg, cap=cap,
                  before=before)
    cap = r.cap
    with record_function("moe/dispatch"):
        x_e = _slot_gather(xt, r.slot_token)                  # (E, G*C, d)
    with record_function("moe/experts"):
        y_e = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], x_e, sp_cfg)
    with record_function("moe/combine"):
        # token side: each assignment reads its slot of y_e (a dropped
        # one slot 0 of its expert, weighted by a zero gate)
        slot = (r.gate_idx * (g * cap)
                + torch.arange(g, device=x.device)[:, None, None] * cap
                + torch.where(r.keep, r.pos, 0))
        y_k = y_e.reshape(-1, d).index_select(0, slot.reshape(-1))
        gates = r.gates.to(x.dtype).to(torch.float32)
        yt = (y_k.reshape(g, sg, k, d).to(torch.float32)
              * gates[..., None]).sum(2)
        yt = yt.to(x.dtype).reshape(t, d)

    if "shared" in p:
        sh = p["shared"]
        xt2 = xt.reshape(t, d)
        h = L.swiglu(_nm_mm(sh["w_gate"], xt2, "moe/shared/w_gate", sp_cfg),
                     _nm_mm(sh["w_up"], xt2, "moe/shared/w_up", sp_cfg))
        yt = yt + _nm_mm(sh["w_down"], h.to(xt2.dtype), "moe/shared/w_down",
                         sp_cfg)

    # Switch-style load-balance aux loss (counts from kept assignments)
    counts = (F.one_hot(r.gate_idx, e) * r.keep[..., None]).sum(
        (0, 1, 2)).to(torch.float32)
    if split is None:
        me = r.probs.mean((0, 1))                            # (E,)
    else:   # the whole batch's: every rank's sums, in rank order
        me = split.sum(r.probs.sum((0, 1))) / (t * split.parts)
        counts = split.sum(counts)
    ce = counts / torch.clamp(counts.sum(), min=1.0)
    aux = e * torch.sum(me * ce)
    return yt.reshape(b, s, d).to(x.dtype), aux
