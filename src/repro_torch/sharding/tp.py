"""Execution of the SERVE_BATCH rules' "model" axis: tensor-parallel serving.

No reference counterpart: the reference resolves its serve specs
(``launch.spmd.serve_shardings``) into ``NamedSharding``s and GSPMD
inserts the collectives at the model's ``act()`` points (the heads over
"model", the KV cache, the FFN hidden, the vocab-sharded logits).  The
port runs one process a rank of a ``launch.mesh.Mesh`` whose "model"
axis has M > 1 ranks, and does it here, Megatron-style:

* Storage.  ``serve_blocks`` cuts each leaf along the dim its spec gives
  "model", as the reference's contiguous split: rank r (its "model"
  coordinate) holds rows or columns [r F/M, (r + 1) F/M).  A packed
  weight's ``vals`` and ``idx`` take w's spec, so its N:M groups stay
  whole (``rules.assert_nm_unsplit``).  ``init_cache`` allocates the
  slot-paged cache at the rank's block shapes: the KV heads over
  "model" where M divides them, else every head on every rank.
* Use.  The serve steps (``train.step.lm_prefill_step`` and
  ``lm_decode_step`` with ``mesh=``) run inside ``model_split``, as the
  MoE layers run inside ``layers.token_split``; the model reads the
  split with ``current()`` and tells from each weight's local shape
  which block of it the rank holds (``ModelSplit.held``):
  - the column-parallel projections (q/k/v, w_gate/w_up, a QKV bias
    with its weight) run on the rank's columns; ``take`` gathers a
    projection's output whole where its block does not hold the heads
    the rank needs (a KV projection cut into half heads, a cache
    replicated over heads);
  - the row-parallel projections (o_proj, w_down) sum their fp32
    partial products over "model" (``model_sum``) before the bias and
    the casts;
  - the embedding is vocab-parallel (``embed_lookup``), bitwise the
    one-process lookup; the vocab-sharded logits are gathered whole
    (``gather_cols``), so every rank's argmax sees the whole row and
    the ranks pick the same tokens.
* ``stats`` counts the collectives a rank takes part in: the bytes of
  the tensors it all-reduces (a ring all-reduce sends 2 (M - 1) / M of
  them a rank), and the bytes it sends in the gathers and lookups.

The all-reduce gives every rank the same bits (the ring and tree
algorithms of gloo and NCCL sum each element on one rank and pass the
sum on), so the ranks' argmaxes agree; the gathers carry 16-bit tensors as their bytes,
which gloo takes where it has no bf16.  There is no fallback: a split
without a process group raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.core import operand as O
from repro_torch.sharding import rules as R

stats = {"all_reduces": 0, "all_reduce_bytes": 0, "gathers": 0,
         "gather_bytes": 0, "embed_lookups": 0, "embed_bytes": 0}


def reset_stats():
    stats.update(dict.fromkeys(stats, 0))


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """This rank's place on the "model" axis: its ``group``, the axis'
    ``parts`` (M) and its ``index`` (r)."""
    group: object
    parts: int
    index: int

    def block(self, full: int) -> tuple:
        """The rank's contiguous block [r full/M, (r + 1) full/M)."""
        size = full // self.parts
        return self.index * size, (self.index + 1) * size

    def held(self, local: int, full: int) -> tuple:
        """The range of a dim of ``full`` that a local size of ``local``
        holds: the whole dim, or the rank's block of it."""
        if local == full:
            return 0, full
        if local * self.parts != full:
            raise ValueError(f"a local size of {local} is neither all nor "
                             f"1/{self.parts} of {full}")
        return self.block(full)


def split_of(mesh) -> Optional[ModelSplit]:
    """The rank's ``ModelSplit`` on ``mesh`` (None when its "model" axis
    has one rank); raises when the axis has no process group."""
    parts = mesh.shape.get("model", 1) if mesh is not None else 1
    if parts == 1:
        return None
    group = mesh.group("model")
    if group is None:
        raise RuntimeError(f"mesh {dict(mesh.shape)} has no process group "
                           "for its 'model' axis: build it over the ranks "
                           "with launch.mesh.mesh_over_group")
    return ModelSplit(group, parts, mesh.coord("model"))


_MODEL_SPLIT = [None]


@contextlib.contextmanager
def model_split(split: Optional[ModelSplit]):
    """Inside it the model runs on the rank's blocks of a model split
    over ``split``'s ranks (None: on the whole model).  A module global,
    as ``layers.token_split``."""
    prev = _MODEL_SPLIT[0]
    _MODEL_SPLIT[0] = split
    try:
        yield
    finally:
        _MODEL_SPLIT[0] = prev


def current() -> Optional[ModelSplit]:
    """The ``model_split`` in force, or None."""
    return _MODEL_SPLIT[0]


# ---------------------------------------------------------------------------
# What executes, and the layout
# ---------------------------------------------------------------------------

_ITEM7 = "ROADMAP item 7"


def check_serve(cfg, mesh) -> None:
    """Refuse a serving mesh or an arch this slice does not execute:
    slot lanes over "pod" or "data", and at "model" > 1 every layer kind
    but dense attention (MoE, MLA, SSM, hybrid) and the
    encoder-decoder."""
    from repro_torch.models import transformer_lm as T

    dp = {a: mesh.shape[a] for a in ("pod", "data")
          if mesh.shape.get(a, 1) > 1}
    if dp:
        raise NotImplementedError(
            f"serving mesh {dict(mesh.shape)}: slot lanes over the DP axes "
            f"{dp} are not ported ({_ITEM7}: slot lanes over 'data'/'pod')")
    if mesh.shape.get("model", 1) == 1:
        return
    if not isinstance(cfg, T.LMConfig):
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder over 'model' is not ported "
            f"({_ITEM7}: build_encdec_serve)")
    kinds = [k for k, on in (("MoE", cfg.moe is not None),
                             ("MLA", cfg.kv_lora is not None),
                             ("SSM or hybrid", cfg.has_ssm)) if on]
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(kinds)} layers over 'model' are not "
            f"ported ({_ITEM7}: expert parallelism and the other layer "
            "kinds over 'model'); tensor-parallel serving runs the dense "
            "attention LMs")


def serve_split(cfg, mesh) -> Optional[ModelSplit]:
    """The rank's ``ModelSplit`` for serving ``cfg`` over ``mesh``
    (``split_of``), refused by ``check_serve`` unless that split is in
    force already: its owner (``serve.batcher.ContinuousBatcher``)
    resolved and checked it once and runs its steps inside it, so the
    decode loop does not check again."""
    split = split_of(mesh)
    if split is not None and split != current():
        check_serve(cfg, mesh)
    return split


def model_dim(spec, mesh) -> Optional[int]:
    """The dim of a leaf that ``mesh``'s "model" axis cuts, or None."""
    out = None
    for i, entry in enumerate(spec or ()):
        if R.shard_count(entry, mesh) == 1:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a != "model" and mesh.shape.get(a, 1) > 1 for a in axes):
            raise NotImplementedError(
                f"spec {spec} cuts over {entry!r}: serving executes the "
                f"'model' axis alone ({_ITEM7}: slot lanes over "
                "'data'/'pod')")
        out = i
    return out


def _block(t: torch.Tensor, dim: Optional[int], parts: int,
           index: int) -> torch.Tensor:
    if dim is None:
        return t
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).clone(
        memory_format=torch.contiguous_format)


def serve_blocks(tree, spec_tree, mesh):
    """This rank's block of every leaf of ``tree`` along the dim its spec
    gives "model" (a contiguous tensor of its own; a leaf that is not
    cut stays as it is).  A dense weight under a packed spec
    (``PackedOp`` of specs) takes the spec of its ``vals``, w's; a
    ``PackedOp`` leaf has its ``vals`` and ``idx`` cut by theirs."""
    parts, index = mesh.shape.get("model", 1), mesh.coord("model")

    def cut(t, spec):
        return _block(t, model_dim(spec, mesh), parts, index)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, s) for v, s in zip(node, spec)]
        if isinstance(node, O.PackedOp):
            return O.PackedOp(cut(node.vals, spec.vals),
                              cut(node.idx, spec.idx), node.cfg,
                              node.idx_bits)
        if isinstance(spec, O.PackedOp):
            spec = spec.vals
        return cut(node, spec) if isinstance(node, torch.Tensor) else node

    return walk(tree, spec_tree)


def leaf_shapes(tree, path=()):
    """{path: shape} of every tensor of a tree of dicts, lists (indices
    in the path) and ``PackedOp``s."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaf_shapes(v, path + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(leaf_shapes(v, path + (i,)))
    elif isinstance(tree, O.PackedOp):
        out[path + ("vals",)] = tuple(tree.vals.shape)
        out[path + ("idx",)] = tuple(tree.idx.shape)
    elif isinstance(tree, torch.Tensor):
        out[path] = tuple(tree.shape)
    return out


def init_cache(cfg, batch: int, max_len: int, mesh, *, device=None,
               dtype=torch.bfloat16):
    """``transformer_lm.init_lm_cache`` at the rank's block shapes of the
    SERVE_BATCH cache specs over ``mesh``."""
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer_lm as T

    device = resolve_device(device)
    meta = T.init_lm_cache(cfg, batch, max_len, device="meta", dtype=dtype)
    specs = R.sanitize_pspecs(R.serve_input_pspecs(
        {"cache": meta}, mesh, long_context=False)["cache"], meta, mesh)
    blocks = serve_blocks(meta, specs, mesh)

    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        if isinstance(node, list):
            return [alloc(v) for v in node]
        if isinstance(node, torch.Tensor):
            return torch.zeros(node.shape, dtype=node.dtype, device=device)
        return node

    return alloc(blocks)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _all_gather(t: torch.Tensor, split: ModelSplit):
    """Every rank's ``t`` in rank order, and the bytes this rank sent."""
    import torch.distributed as dist

    wire = t.contiguous()
    if wire.dtype in (torch.bfloat16, torch.float16):
        wire = wire.view(torch.uint8)
    got = [torch.empty_like(wire) for _ in range(split.parts)]
    dist.all_gather(got, wire, group=split.group)
    sent = wire.numel() * wire.element_size() * (split.parts - 1)
    return [g.view(t.dtype) for g in got], sent


def model_sum(y: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    """The fp32 partial products of a row-parallel projection summed
    over "model" (an all-reduce, in place)."""
    import torch.distributed as dist

    y = y.contiguous()
    dist.all_reduce(y, group=split.group)
    stats["all_reduces"] += 1
    stats["all_reduce_bytes"] += y.numel() * y.element_size()
    return y


def gather_cols(y: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    """Every rank's column block of ``y`` (the rank's block of its last
    dim) joined whole, in rank order."""
    parts, sent = _all_gather(y, split)
    stats["gathers"] += 1
    stats["gather_bytes"] += sent
    return torch.cat(parts, dim=-1)


def take(y: torch.Tensor, have: tuple, want: tuple, full: int,
         split: ModelSplit) -> torch.Tensor:
    """Columns ``want`` = (lo, hi) of a last dim of size ``full``, from
    ``y``, which holds columns ``have`` (all of them, or the rank's
    block): a slice where ``have`` covers ``want``, else a slice of ``y``
    gathered whole over "model"."""
    if have == want:
        return y
    if not have[0] <= want[0] <= want[1] <= have[1]:
        y, have = gather_cols(y, split), (0, full)
    return y[..., want[0] - have[0]:want[1] - have[0]]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 split: ModelSplit) -> torch.Tensor:
    """The vocab-parallel lookup of ``tokens`` in the rank's row block of
    the table: the rows in the rank's range, zeros for the rest, then
    every rank's rows exchanged and each token's taken from the rank
    that holds it: bitwise the one-process lookup (a sum over "model"
    with one non-zero term, without its -0 + 0 rounding)."""
    rows = table.shape[0]
    lo = split.index * rows
    mine = (tokens >= lo) & (tokens < lo + rows)
    got = table[torch.where(mine, tokens - lo, 0)]
    got = torch.where(mine[..., None], got, torch.zeros_like(got))
    parts, sent = _all_gather(got, split)
    owner = torch.div(tokens, rows, rounding_mode="floor").clamp_(
        0, split.parts - 1)
    stats["embed_lookups"] += 1
    stats["embed_bytes"] += sent
    return torch.stack(parts).gather(
        0, owner[None, ..., None].expand(1, *got.shape))[0]
