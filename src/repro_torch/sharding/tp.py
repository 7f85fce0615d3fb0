"""Execution of the SERVE_BATCH rules over a mesh of processes: the
"model" axis (tensor-parallel serving) and the slot lanes over the DP
axes ("pod", "data").

No reference counterpart: the reference resolves its serve specs
(``launch.spmd.serve_shardings``) into ``NamedSharding``s and GSPMD
inserts the collectives at the model's ``act()`` points (the heads over
"model", the KV cache, the FFN hidden, the vocab-sharded logits, the
batch over the DP axes).  The port runs one process a rank of a
``launch.mesh.Mesh`` and does it here, Megatron-style:

* Storage.  ``serve_blocks`` cuts each leaf along every dim its spec
  cuts, as the reference's contiguous split: rank r holds rows or
  columns [r F/M, (r + 1) F/M) of a dim over "model" (r its "model"
  coordinate), and slots [i S/D, (i + 1) S/D) of a slot axis over the
  DP axes (i its DP index, ``Mesh.dp_index``).  A weight is cut by
  "model" alone (the SERVE_BATCH rules put no weight over DP).  A
  packed weight's ``vals`` and ``idx`` take w's spec, so its N:M groups
  stay whole (``rules.assert_nm_unsplit``); a shared-pattern
  ``SharedOp`` keeps ``vals`` on w's spec and ``idx`` on w's without its
  feature entry, and a row block's ``idx`` is rebased to the rank's K
  block.  ``init_cache`` allocates the slot-paged cache of the rank's
  slots (``slot_block``: its block over the DP axes where D divides
  them, else every slot, as ``_sanitize_pspec`` replicates them) at
  the rank's block shapes over "model": the KV heads over "model"
  where M divides them, else every head on every rank.
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
  Over the DP axes (``SlotSplit``) a rank runs its own slots' rows; the
  owners' int token ids are gathered whole once a decode step
  (``gather_rows``, as the logits of ``build_lm_serve``), and a lane
  another rank holds comes from its owner (``share``).  The MoE layers
  route over the whole batch (``layers.token_split`` over the DP
  group), as the reference's one program does.
* ``stats`` counts the collectives a rank takes part in: the bytes of
  the tensors it all-reduces (a ring all-reduce sends 2 (M - 1) / M of
  them a rank), and the bytes it sends in the gathers, lookups and
  lane shares.

The all-reduce gives every rank the same bits (the ring and tree
algorithms of gloo and NCCL sum each element on one rank and pass the
sum on), so the ranks' argmaxes agree; the gathers carry 16-bit tensors
as their bytes, which gloo takes where it has no bf16.  There is no
fallback: a split without a process group raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.core import operand as O
from repro_torch.launch.mesh import DP_AXES, Mesh
from repro_torch.sharding import rules as R

stats = {"all_reduces": 0, "all_reduce_bytes": 0, "gathers": 0,
         "gather_bytes": 0, "embed_lookups": 0, "embed_bytes": 0,
         "dp_gathers": 0, "dp_gather_bytes": 0, "lane_shares": 0,
         "lane_share_bytes": 0}


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
    """Refuse what serving over ``mesh`` does not execute: at "model" >
    1 every layer kind but dense attention (MoE, MLA, SSM, hybrid) and
    the encoder-decoder.  Slot lanes over the DP axes run for every LM
    arch."""
    from repro_torch.models import transformer_lm as T

    if mesh.shape.get("model", 1) == 1:
        return
    if not isinstance(cfg, T.LMConfig):
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder over 'model' is not ported "
            f"({_ITEM7}.4: build_encdec_serve)")
    kinds = [k for k, on in (("MoE", cfg.moe is not None),
                             ("MLA", cfg.kv_lora is not None),
                             ("SSM or hybrid", cfg.has_ssm)) if on]
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(kinds)} layers over 'model' are not "
            f"ported ({_ITEM7}.3: expert parallelism and the other layer "
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


def entry_part(entry, mesh) -> tuple:
    """(parts, index): how many ways one spec entry cuts its dim on
    ``mesh``, and which part this rank holds (row-major over the
    entry's axes: over ("pod", "data") its DP index)."""
    parts, index = 1, 0
    for a in (() if entry is None else
              entry if isinstance(entry, tuple) else (entry,)):
        size = mesh.shape.get(a, 1)
        parts, index = parts * size, index * size + mesh.coord(a)
    return parts, index


def _block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The rank's block of ``t``: every dim cut by its spec entry (a
    contiguous tensor of its own; ``t`` itself when nothing cuts)."""
    out = t
    for dim, entry in enumerate(spec or ()):
        parts, index = entry_part(entry, mesh)
        if parts > 1:
            size = t.shape[dim] // parts
            out = out.narrow(dim, index * size, size)
    if out is t:
        return t
    return out.clone(memory_format=torch.contiguous_format)


def _shared_block(op, spec, mesh):
    """The rank's block of a ``SharedOp`` (packed whole first, so that
    its pattern is the whole weight's): ``vals`` by w's spec; ``idx`` by
    its own, and where that cuts K (a row-parallel site) the block's
    rows rebased to the rank's K block, checked in range (the kernel
    does not bound-check the rows it gathers)."""
    vals, idx = _block(op.vals, spec.vals, mesh), _block(op.idx, spec.idx,
                                                           mesh)
    parts, index = entry_part(spec.idx[0] if spec.idx else None, mesh)
    if parts == 1:
        return O.SharedOp(vals, idx, op.k)
    if op.k is None or op.k % parts:
        raise ValueError(f"a SharedOp of K = {op.k} does not cut into "
                         f"{parts} row blocks")
    k = op.k // parts
    idx = idx - index * k
    if not idx.is_meta and idx.numel() and not (
            int(idx.min()) >= 0 and int(idx.max()) < k):
        raise ValueError(f"a row block's rebased rows leave [0, {k}): the "
                         "pattern's groups cross the rank's K block")
    return O.SharedOp(vals, idx, k)


def serve_blocks(tree, spec_tree, mesh):
    """This rank's block of every leaf of ``tree`` along every dim its
    spec cuts (a contiguous tensor of its own; a leaf that is not cut
    stays as it is).  A dense weight under a packed spec (``PackedOp``
    of specs) takes the spec of its ``vals``, w's; a ``PackedOp`` leaf
    has its ``vals`` and ``idx`` cut by theirs, a ``SharedOp`` leaf too
    (``_shared_block``)."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, s) for v, s in zip(node, spec)]
        if isinstance(node, O.PackedOp):
            return O.PackedOp(_block(node.vals, spec.vals, mesh),
                              _block(node.idx, spec.idx, mesh), node.cfg,
                              node.idx_bits)
        if isinstance(node, O.SharedOp):
            return _shared_block(node, spec, mesh)
        if isinstance(spec, (O.PackedOp, O.SharedOp)):
            spec = spec.vals
        return _block(node, spec, mesh) if isinstance(
            node, torch.Tensor) else node

    return walk(tree, spec_tree)


def leaf_shapes(tree, path=()):
    """{path: shape} of every tensor of a tree of dicts, lists (indices
    in the path), ``PackedOp``s and ``SharedOp``s."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaf_shapes(v, path + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(leaf_shapes(v, path + (i,)))
    elif isinstance(tree, (O.PackedOp, O.SharedOp)):
        out[path + ("vals",)] = tuple(tree.vals.shape)
        out[path + ("idx",)] = tuple(tree.idx.shape)
    elif isinstance(tree, torch.Tensor):
        out[path] = tuple(tree.shape)
    return out


def init_cache(cfg, batch: int, max_len: int, mesh, *, device=None,
               dtype=torch.bfloat16):
    """``transformer_lm.init_lm_cache`` of the rank's ``batch`` rows (its
    slots over the DP axes, ``slot_block``'s width; a step's rows) at
    the rank's block shapes over "model" of the SERVE_BATCH cache
    specs."""
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer_lm as T

    device = resolve_device(device)
    # "model" alone: the rows given are already the rank's
    model = Mesh({"data": 1, "model": mesh.shape.get("model", 1)},
                 mesh.coord("model"))
    meta = T.init_lm_cache(cfg, batch, max_len, device="meta", dtype=dtype)
    specs = R.sanitize_pspecs(R.serve_input_pspecs(
        {"cache": meta}, model, long_context=False)["cache"], meta, model)
    blocks = serve_blocks(meta, specs, model)

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
# Slot lanes over the DP axes
# ---------------------------------------------------------------------------


def slot_block(n: int, mesh) -> tuple:
    """The slots [lo, hi) of a slot axis of ``n`` that this rank holds:
    its DP index' contiguous block where D divides ``n``, else all of
    them (``_sanitize_pspec`` replicates the axis, as the reference)."""
    spec = R._sanitize_pspec((R.batch_entry(mesh),), (n,), mesh)
    parts, index = entry_part(spec[0], mesh)
    size = n // parts
    return index * size, (index + 1) * size


@dataclasses.dataclass(frozen=True)
class SlotSplit:
    """This rank's slots [lo, hi) of ``n`` over the ``parts`` DP ranks of
    ``group`` (the rank at DP index ``index``, the group's rank order).
    Replicated (every slot on every rank) where D does not divide
    ``n``."""
    group: object
    parts: int
    index: int
    n: int
    lo: int
    hi: int

    @property
    def replicated(self) -> bool:
        return self.hi - self.lo == self.n

    def holds(self, slot: int) -> bool:
        return self.lo <= slot < self.hi

    def owner(self, slot: int) -> int:
        """The DP index of a rank that holds ``slot`` (this one where the
        slots are replicated)."""
        return (self.index if self.replicated
                else slot // (self.hi - self.lo))


def slot_split(mesh, n: int) -> Optional[SlotSplit]:
    """The rank's ``SlotSplit`` of ``n`` slots over ``mesh``'s DP axes
    (None when they have one rank); raises when they have no process
    group."""
    if mesh is None or mesh.dp_size == 1:
        return None
    group = mesh.dp_group()
    if group is None:
        raise RuntimeError(f"mesh {dict(mesh.shape)} has no process group "
                           "over its DP axes: build it over the ranks "
                           "with launch.mesh.mesh_over_group")
    lo, hi = slot_block(n, mesh)
    return SlotSplit(group, mesh.dp_size, mesh.dp_index, n, lo, hi)


def rows_split(mesh, n: int):
    """The ``layers.token_split`` of a batch of ``n`` rows over
    ``mesh``'s DP axes (the MoE routing groups over every rank's rows),
    None where the rows are not cut."""
    from repro_torch.sharding import fsdp as F

    lo, hi = slot_block(n, mesh)
    return None if hi - lo == n else F.token_split(mesh, DP_AXES)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo carries it: a 16-bit float as its bytes."""
    wire = t.contiguous()
    return (wire.view(torch.uint8)
            if wire.dtype in (torch.bfloat16, torch.float16) else wire)


def _all_gather(t: torch.Tensor, split):
    """Every rank's ``t`` in rank order over ``split``'s group (a
    ``ModelSplit`` or a ``SlotSplit``), and the bytes this rank sent."""
    import torch.distributed as dist

    wire = _wire(t)
    got = [torch.empty_like(wire) for _ in range(split.parts)]
    dist.all_gather(got, wire, group=split.group)
    sent = wire.numel() * wire.element_size() * (split.parts - 1)
    return [g.view(t.dtype) for g in got], sent


def gather_rows(y: torch.Tensor, split: SlotSplit) -> torch.Tensor:
    """Every DP rank's rows of ``y`` (its slots, dim 0) joined whole, in
    DP order; ``y`` itself where the rows are replicated."""
    if split is None or split.replicated:
        return y
    parts, sent = _all_gather(y, split)
    stats["dp_gathers"] += 1
    stats["dp_gather_bytes"] += sent
    return torch.cat(parts, dim=0)


def share(tensors: list, owner: int, split: SlotSplit) -> list:
    """``tensors`` (contiguous) as the rank at DP index ``owner`` holds
    them, on every DP rank (a broadcast over the DP group; the others
    pass buffers of the same shapes, written in place)."""
    import torch.distributed as dist

    src = dist.get_global_rank(split.group, owner)
    sent = 0
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("share: a tensor that is not contiguous")
        wire = _wire(t)   # a view of t: the broadcast writes t itself
        dist.broadcast(wire, src, group=split.group)
        sent += wire.numel() * wire.element_size()
    stats["lane_shares"] += 1
    stats["lane_share_bytes"] += sent if owner == split.index else 0
    return tensors


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
