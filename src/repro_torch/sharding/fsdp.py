"""Execution of the TRAIN rules' "data" axis: fully sharded data parallel.

No reference counterpart: the reference resolves its specs
(``sharding.rules``) into ``NamedSharding``s and GSPMD inserts the
collectives.  The port runs one process a rank of a ``launch.mesh.Mesh``
and does it here, for meshes whose "model" axis is 1 (a "model" axis of
more raises; ROADMAP item 7, part 3):

* Storage.  A rank keeps its block of each leaf of the train state, per
  the leaf's resolved spec: the dim whose entry names "data" cut in D
  equal parts, part ``d`` on the rank at data coordinate ``d``; every
  other leaf whole.  A block is a contiguous tensor of its own, column
  blocks too (``w_down``'s (F, d/D)).  A pre-generated site's fields
  (``bp``, ``ff`` or packed ``vals``/``idx``, ``mask``) take the
  master weight's spec, so packed operands are cut along Kc in whole
  N-runs, which the group guard (``rules.assert_nm_unsplit``) asserts.
* Use.  ``step_view`` gives the step a tree whose top-level leaves (the
  embedding, the final norm, lm_head, a prelude) are gathered once for
  the step, and whose per-layer blocks are ``ShardedBlock``s: the model
  reads each through ``models.layers.gathered``, so a block's full
  operands are gathered just before its layers run and freed after,
  and, inside the block's recompute, gathered again.  A site's decay
  mask is the update's alone and is not gathered.  An untied embedding
  table, cut along its columns, is read through ``RowLookup``: a step
  moves its tokens' rows, not the table (``_RowGather``).
* Gradients.  A gather is a ``torch.autograd.Function``; its backward
  reduces each full gradient to the rank's block: the D ranks' parts
  are exchanged with ``all_to_all_single`` (a replicated leaf's whole
  gradients with ``all_gather``), summed in fp32 in rank order and
  multiplied by float32(1/D) (``kernels.ref.inv_pods``, as the pod
  mean), then rounded to the leaf's dtype.  The order is fixed, so a run
  is deterministic at any D; gloo has no ``reduce_scatter``, and both
  collectives serve on gloo and NCCL.  Each rank computes its loss on
  its own rows, so the reduced gradient is the data mean of the pod's.
* ``stats`` counts the step's gathers and reductions and the bytes each
  rank sends in them (a checkpoint's gathers are not counted).

bf16 and bool tensors travel as their bytes (gloo carries neither
int16 nor bool everywhere), as the compressed sync's payload does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.operand import PregenOp
from repro_torch.kernels.ref import inv_pods
from repro_torch.launch.mesh import DP_AXES
from repro_torch.optim import compress as C
from repro_torch.optim import sgd
from repro_torch.sharding import rules as R

STACKS = ("blocks", "enc_blocks", "dec_blocks")
PREGEN_FIELDS = ("bp", "ff", "vals", "idx", "mask")

stats = {"gathers": 0, "gather_bytes": 0, "reductions": 0,
         "reduce_bytes": 0}


def reset_stats():
    stats.update(gathers=0, gather_bytes=0, reductions=0, reduce_bytes=0)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def shard_dim(spec, mesh) -> Optional[int]:
    """The dim of a leaf that ``mesh``'s "data" axis cuts, or None.
    Raises NotImplementedError for a spec that cuts along another axis of
    more than one rank ("model": ROADMAP item 7, part 3)."""
    out = None
    for i, entry in enumerate(spec or ()):
        if R.shard_count(entry, mesh) == 1:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a != "data" and mesh.shape.get(a, 1) > 1 for a in axes):
            raise NotImplementedError(
                f"spec {spec} shards over {entry!r}: only the 'data' axis "
                "executes here (tensor and expert parallelism over "
                "'model' are ROADMAP item 7, part 3)")
        out = i
    return out


def block_of(t: torch.Tensor, dim: Optional[int], parts: int,
             index: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` of ``t`` along ``dim``, a contiguous
    tensor of its own (``t`` itself when ``dim`` is None)."""
    if dim is None or parts == 1:
        return t
    size = t.shape[dim] // parts
    if size * parts != t.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {parts}")
    return t.narrow(dim, index * size, size).clone(
        memory_format=torch.contiguous_format)


def _pairs(node, spec, out, fields=PREGEN_FIELDS):
    """(tensor, spec) of every tensor of a subtree, in tree order (a
    ``PregenOp``'s present ``fields``, in ``PREGEN_FIELDS`` order)."""
    if isinstance(node, dict):
        for k, v in node.items():
            _pairs(v, spec[k], out, fields)
    elif isinstance(node, list):
        for v, s in zip(node, spec):
            _pairs(v, s, out, fields)
    elif isinstance(node, PregenOp):
        for f in fields:
            t = getattr(node, f)
            if t is not None:
                out.append((t, getattr(spec, f) if isinstance(
                    spec, PregenOp) else spec))
    elif isinstance(node, torch.Tensor):
        out.append((node, spec))
    return out


def _rebuild(node, it, fields=PREGEN_FIELDS):
    """``node``'s structure with its tensors taken from ``it`` in
    ``_pairs`` order (a ``PregenOp``'s other fields left out)."""
    if isinstance(node, dict):
        return {k: _rebuild(v, it, fields) for k, v in node.items()}
    if isinstance(node, list):
        return [_rebuild(v, it, fields) for v in node]
    if isinstance(node, PregenOp):
        return PregenOp(**{f: (None if getattr(node, f) is None
                               or f not in fields else next(it))
                           for f in PREGEN_FIELDS},
                        cfg=node.cfg, idx_bits=node.idx_bits)
    if isinstance(node, torch.Tensor):
        return next(it)
    return node


def tensors(tree) -> list:
    """Every tensor of a tree of dicts, lists and ``PregenOp``s."""
    out = []
    if isinstance(tree, dict):
        for v in tree.values():
            out += tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            out += tensors(v)
    elif isinstance(tree, PregenOp):
        out += [getattr(tree, f) for f in PREGEN_FIELDS
                if getattr(tree, f) is not None]
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def map_blocks(tree, spec_tree, fn):
    """``tree`` with each tensor t replaced by fn(t, spec)."""
    pairs = _pairs(tree, spec_tree, [])
    return _rebuild(tree, iter([fn(t, s) for t, s in pairs]))


def shard_tree(tree, spec_tree, mesh):
    """This rank's blocks of a full tree (every leaf, in place where it
    is not cut)."""
    d, r = mesh.shape.get("data", 1), mesh.coord("data")
    return map_blocks(tree, spec_tree, lambda t, s: block_of(
        t, shard_dim(s, mesh), d, r))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    if t.dtype in (torch.bfloat16, torch.float16, torch.bool):
        return t.contiguous().view(torch.uint8)
    return t.contiguous()


def _unwire(w: torch.Tensor, dtype) -> torch.Tensor:
    return w.view(dtype) if w.dtype != dtype else w


def gather_leaf(t: torch.Tensor, dim: Optional[int], group,
                parts: int, count: bool = True) -> torch.Tensor:
    """The full leaf from every rank's block along ``dim`` (rank order);
    ``count``: add it to ``stats``."""
    import torch.distributed as dist

    if dim is None or parts == 1:
        return t
    wire = _wire(t)
    got = [torch.empty_like(wire) for _ in range(parts)]
    dist.all_gather(got, wire, group=group)
    if count:
        stats["gathers"] += 1
        stats["gather_bytes"] += (wire.numel() * wire.element_size()
                                  * (parts - 1))
    return _unwire(torch.cat(got, dim), t.dtype)


def gather_to_first(t: torch.Tensor, dim: int, group, parts: int):
    """The full leaf from every rank's block along ``dim`` (rank order),
    in host memory on the group's first rank, None on the others (gloo
    gathers host copies; NCCL the device blocks)."""
    import torch.distributed as dist

    wire = _wire(t)
    if dist.get_backend(group) != "nccl":
        wire = wire.cpu()
    first = (0 if group is None or group is dist.group.WORLD
             else dist.get_global_rank(group, 0))
    got = ([torch.empty_like(wire) for _ in range(parts)]
           if dist.get_rank() == first else None)
    dist.gather(wire, got, dst=first, group=group)
    if got is None:
        return None
    return _unwire(torch.cat([g.cpu() for g in got], dim), t.dtype)


def reduce_leaf(g: torch.Tensor, dim: Optional[int], group,
                parts: int) -> torch.Tensor:
    """The rank's block of the mean over the ``parts`` ranks of their full
    gradients ``g``: the parts summed in fp32 in rank order, times
    float32(1/parts), in ``g``'s dtype."""
    import torch.distributed as dist

    if parts == 1:
        return g
    if dim is None:   # a replicated leaf: every rank's whole gradient
        wire = _wire(g)
        recv = [torch.empty_like(wire) for _ in range(parts)]
        dist.all_gather(recv, wire, group=group)
        sent = wire.numel() * wire.element_size() * (parts - 1)
        pieces = [_unwire(x, g.dtype) for x in recv]
    else:             # part j of every rank's gradient goes to rank j
        size = g.shape[dim] // parts
        send = g.unflatten(dim, (parts, size)).movedim(dim, 0).contiguous()
        wire = _wire(send)
        recv = torch.empty_like(wire)
        dist.all_to_all_single(recv, wire, group=group)
        sent = wire.numel() * wire.element_size() * (parts - 1) // parts
        pieces = list(_unwire(recv, g.dtype).unbind(0))
    stats["reductions"] += 1
    stats["reduce_bytes"] += sent
    acc = pieces[0].to(torch.float32)
    for x in pieces[1:]:
        acc = acc + x.to(torch.float32)
    return (acc * inv_pods(parts)).to(g.dtype)


class _Gather(torch.autograd.Function):
    """Full tensors from blocks; the backward reduces each full gradient
    to the block (``reduce_leaf``), a leaf the step did not read with a
    zero gradient, so that every rank runs the same collectives."""

    @staticmethod
    def forward(ctx, info, *blocks):
        group, parts, dims = info
        ctx.info = info
        ctx.full = [(tuple(s * (parts if i == d else 1)
                           for i, s in enumerate(t.shape)), t.dtype, t.device)
                    for t, d in zip(blocks, dims)]
        ctx.set_materialize_grads(False)
        outs = tuple(gather_leaf(t, d, group, parts)
                     for t, d in zip(blocks, dims))
        ctx.mark_non_differentiable(*[
            o for o, t in zip(outs, blocks)
            if not (t.is_floating_point() and t.requires_grad)])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        group, parts, dims = ctx.info
        out = [None]
        for i, (g, d) in enumerate(zip(grads, dims)):
            if not ctx.needs_input_grad[i + 1]:
                out.append(None)
                continue
            if g is None:
                shape, dtype, device = ctx.full[i]
                g = torch.zeros(shape, dtype=dtype, device=device)
            out.append(reduce_leaf(g, d, group, parts))
        return tuple(out)


def _gather_pairs(pairs, mesh):
    group, parts = mesh.group("data"), mesh.shape.get("data", 1)
    blocks = [t for t, _ in pairs]
    dims = tuple(shard_dim(s, mesh) for _, s in pairs)
    if not torch.is_grad_enabled() or not any(t.requires_grad
                                              for t in blocks):
        return [gather_leaf(t, d, group, parts)
                for t, d in zip(blocks, dims)]
    return _Gather.apply((group, parts, dims), *blocks)


class _SumOverRanks(torch.autograd.Function):
    """Every rank's ``x`` summed in fp32 in rank order; the backward is
    the same sum of every rank's gradient, so that the data mean of the
    ranks' gradients is the gradient of the one sum."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _rank_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _rank_sum(g, ctx.group)


def _rank_sum(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    got = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, x.contiguous(), group=group)
    acc = got[0].to(torch.float32)
    for y in got[1:]:
        acc = acc + y.to(torch.float32)
    return acc.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TokenSplit:
    """The ranks a batch is split over, this rank's block ``index`` of
    ``parts`` (``models.layers.token_split``): ``sum`` adds a small
    tensor over them (differentiable), ``gather`` stacks it (parts,
    ...)."""
    group: object
    parts: int
    index: int

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _SumOverRanks.apply(self.group, x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        got = [torch.empty_like(x) for _ in range(self.parts)]
        dist.all_gather(got, x.contiguous(), group=self.group)
        return torch.stack(got)


def token_split(mesh, axes):
    """The ``TokenSplit`` of the batch over ``mesh``'s ``axes`` ("data",
    or ``DP_AXES`` when one program spans the pods: the mesh's DP group,
    the rank at its DP index), None when they have one rank."""
    if tuple(axes) == DP_AXES:
        size, group, index = mesh.dp_size, mesh.dp_group(), mesh.dp_index
    else:
        (axis,) = axes
        size, group, index = (mesh.shape.get(axis, 1), mesh.group(axis),
                              mesh.coord(axis))
    if size == 1:
        return None
    if group is None:
        raise RuntimeError(f"mesh {dict(mesh.shape)} has no process group "
                           f"over {tuple(axes)}: build it over the ranks "
                           "with launch.mesh.mesh_over_group")
    return TokenSplit(group, size, index)


def gather_tree(local, spec_tree, mesh, to=None):
    """The full tree from every rank's blocks (no autograd), each leaf
    moved to ``to`` (a device) as soon as it is gathered: checkpoints
    and tests."""
    group, parts = mesh.group("data"), mesh.shape.get("data", 1)

    def one(t, spec):
        full = gather_leaf(t, shard_dim(spec, mesh), group, parts,
                           count=False)
        return full if to is None else full.to(to)

    with torch.no_grad():
        return map_blocks(local, spec_tree, one)


# what the model reads of a pre-generated site: the decay mask is the
# update's alone (it stays a block, ungathered)
READ_FIELDS = ("bp", "ff", "vals", "idx")


class ShardedBlock:
    """One layer's blocks and their specs; ``gather()`` (called by the
    model through ``layers.gathered``) gives the layer's full params as
    the model reads them (a site's decay mask left out), differentiable
    back to the blocks."""

    def __init__(self, local, specs, mesh):
        self.local, self.specs, self.mesh = local, specs, mesh

    def gather(self):
        pairs = _pairs(self.local, self.specs, [], READ_FIELDS)
        return _rebuild(self.local, iter(_gather_pairs(pairs, self.mesh)),
                        READ_FIELDS)


class _RowGather(torch.autograd.Function):
    """An embedding lookup on a table cut along its columns: this rank's
    rows of the full table at its own tokens.  Every rank's tokens are
    gathered, each rank looks up its column block at all of them, and an
    ``all_to_all`` hands each rank its tokens' blocks.  The backward
    sends each rank's row gradients back the same way; each rank scales
    every rank's rows by float32(1/D) (exact for a power of two) and
    puts them into its column block with the lookup's own backward
    (``index_put_`` accumulating, in the table's dtype), tokens in rank
    order, which is the global batch's order: the table's gradient as
    the one-process step takes it, repeated tokens accumulated the same
    way (in bf16 on the card: PERF.md §7)."""

    @staticmethod
    def forward(ctx, info, block, tokens):
        import torch.distributed as dist

        group, parts = info
        flat = tokens.reshape(-1)
        ids = [torch.empty_like(flat) for _ in range(parts)]
        dist.all_gather(ids, flat.contiguous(), group=group)
        rows = torch.stack([block[i] for i in ids])      # (D, T, d/D)
        got = torch.empty_like(_wire(rows))
        dist.all_to_all_single(got, _wire(rows), group=group)
        stats["gathers"] += 1
        stats["gather_bytes"] += (rows[0].numel() * rows.element_size()
                                  * (parts - 1))
        ctx.info, ctx.ids, ctx.vocab = info, ids, block.shape[0]
        out = _unwire(got, block.dtype).movedim(0, -2)   # (T, D, d/D)
        return out.reshape(*tokens.shape, -1)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        group, parts = ctx.info
        width = g.shape[-1] // parts
        send = g.reshape(-1, parts, width).movedim(1, 0).contiguous()
        got = torch.empty_like(_wire(send))
        dist.all_to_all_single(got, _wire(send), group=group)
        stats["reductions"] += 1
        stats["reduce_bytes"] += (send[0].numel() * send.element_size()
                                  * (parts - 1))
        rows = _unwire(got, g.dtype) * inv_pods(parts)
        grad = torch.zeros((ctx.vocab, width), dtype=g.dtype,
                           device=g.device)
        grad.index_put_((torch.cat(ctx.ids),), rows.reshape(-1, width),
                        accumulate=True)
        return None, grad, None


class RowLookup:
    """A column-cut embedding table the model indexes with its tokens
    (``layers.embed_apply``: ``table[tokens]``), through ``_RowGather``."""

    def __init__(self, block, mesh):
        self.block, self.mesh = block, mesh

    def __getitem__(self, tokens):
        info = (self.mesh.group("data"), self.mesh.shape["data"])
        return _RowGather.apply(info, self.block, tokens)


def step_view(local, spec_tree, mesh, rows_only=()):
    """The tree a step's model reads: the top-level leaves gathered now
    (once for the step), each per-layer block a ``ShardedBlock``.  A
    column-cut embedding table under a key of ``rows_only`` (one the
    model only indexes with tokens: an untied ``"embed"``) is a
    ``RowLookup``: a step moves its tokens' rows, not the table.  On a
    mesh without a "data" axis of more than one rank, ``local``
    itself."""
    if mesh.shape.get("data", 1) == 1:
        return local
    rows = {k for k in rows_only if k in local
            and shard_dim(spec_tree[k]["embed_table"], mesh) == 1}
    top = [k for k in local if k not in STACKS and k not in rows]
    shell = ShardedBlock({k: local[k] for k in top},
                         {k: spec_tree[k] for k in top}, mesh).gather()
    shell.update({k: {"embed_table": RowLookup(local[k]["embed_table"],
                                               mesh)} for k in rows})
    return {k: ([ShardedBlock(b, s, mesh)
                 for b, s in zip(local[k], spec_tree[k])]
                if k in STACKS else shell[k]) for k in local}


def reduce_tree(grads, spec_tree, mesh, axis: str):
    """The mean over ``axis``'s ranks of a tree of same-shaped blocks
    (each rank's), in rank order: the dense pod mean."""
    group, parts = mesh.group(axis), mesh.shape.get(axis, 1)
    if parts == 1:
        return grads
    return map_blocks(grads, spec_tree,
                      lambda g, _: reduce_leaf(g, None, group, parts))


# ---------------------------------------------------------------------------
# The residual of the compressed sync
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ErrLayout:
    """Where each rank's residual columns sit in the one-process layout
    (``optim.compress.plan_for`` of the full master, one row a pod):
    ``moves[i]`` = (full column, rank column, leaf shape, dim) of leaf
    i, None where either side keeps no residual for it."""
    moves: tuple
    width: int          # the one-process (full) width
    local_width: int    # a rank's width


def err_layout(lshapes_leaves, local_plan, full_plan, dims) -> ErrLayout:
    moves = []
    for shape, lo, fo, dim in zip(lshapes_leaves, local_plan.offsets,
                                  full_plan.offsets, dims):
        moves.append(None if lo is None or fo is None
                     else (fo, lo, tuple(shape), dim))
    return ErrLayout(tuple(moves), full_plan.width, local_plan.width)


def err_block(full_row: torch.Tensor, layout: ErrLayout, parts: int,
              index: int) -> torch.Tensor:
    """A rank's (rows, local width) residual from the one-process rows."""
    out = full_row.new_zeros((full_row.shape[0], layout.local_width))
    for move in layout.moves:
        if move is None:
            continue
        fo, lo, shape, dim = move
        numel = 1
        for s in shape:
            numel *= s
        leaf = full_row[:, fo:fo + numel].reshape(-1, *shape)
        part = block_of(leaf, None if dim is None else dim + 1, parts,
                        index)
        out[:, lo:lo + part[0].numel()] = part.reshape(part.shape[0], -1)
    return out


def err_merge(blocks, layout: ErrLayout) -> torch.Tensor:
    """The one-process (rows, width) residual from every data rank's
    (rows, local width) block, in data order."""
    parts = len(blocks)
    out = blocks[0].new_zeros((blocks[0].shape[0], layout.width))
    for move in layout.moves:
        if move is None:
            continue
        fo, lo, shape, dim = move
        numel = 1
        for s in shape:
            numel *= s
        if dim is None:
            out[:, fo:fo + numel] = blocks[0][:, lo:lo + numel]
            continue
        lshape = list(shape)
        lshape[dim] //= parts
        n_loc = numel // parts
        pieces = [b[:, lo:lo + n_loc].reshape(-1, *lshape) for b in blocks]
        out[:, fo:fo + numel] = torch.cat(pieces, dim + 1).reshape(
            out.shape[0], -1)
    return out


# ---------------------------------------------------------------------------
# A whole train state
# ---------------------------------------------------------------------------


_TREES = ("master", "momentum", "compute")


def _callables(node, out):
    """The functions of a ``StateSharding.lazy`` tree, in tree order."""
    if isinstance(node, dict):
        for v in node.values():
            _callables(v, out)
    elif isinstance(node, list):
        for v in node:
            _callables(v, out)
    elif isinstance(node, PregenOp):
        for f in PREGEN_FIELDS:
            _callables(getattr(node, f), out)
    elif callable(node):
        out.append(node)
    return out


def _fill(node, it):
    """``node`` with each function replaced by the next of ``it``."""
    if isinstance(node, dict):
        return {k: _fill(v, it) for k, v in node.items()}
    if isinstance(node, list):
        return [_fill(v, it) for v in node]
    if isinstance(node, PregenOp):
        return PregenOp(**{f: _fill(getattr(node, f), it)
                           for f in PREGEN_FIELDS},
                        cfg=node.cfg, idx_bits=node.idx_bits)
    return next(it) if callable(node) else node


@dataclasses.dataclass(frozen=True)
class StateSharding:
    """A train state's resolved specs on ``mesh`` (``specs``: "master",
    "momentum", "step", and "compute" / "err" where the state has them),
    the master's logical shapes, the sync's m and the compute tree's
    packing: cuts a whole state into a rank's blocks and gathers it
    back to rank 0, leaf by leaf, the residual included (its one-process
    layout: ``err_block``, ``err_merge``)."""
    mesh: object
    specs: dict
    lshapes: object
    m: int = 8
    pregen_pack: bool = True

    @property
    def sharded(self) -> bool:
        return self.mesh.size > 1

    def without(self, key: str) -> "StateSharding":
        return dataclasses.replace(self, specs={
            k: v for k, v in self.specs.items() if k != key})

    def with_specs(self, **specs) -> "StateSharding":
        return dataclasses.replace(self, specs=dict(self.specs, **specs))

    def _master(self, local: bool):
        """The master's shapes as meta tensors, whole or a rank's."""
        return sgd.tree_map(lambda _, shape, spec: torch.empty(
            C.local_block_shape(shape, spec, self.mesh) if local else shape,
            device="meta"), self.lshapes, self.specs["master"])

    def err_layout(self) -> ErrLayout:
        full = C.plan_for(self._master(False), self.m, self.m)
        loc = C.plan_for(self._master(True), self.m, self.m)
        dims = [shard_dim(s, self.mesh)
                for s in sgd.tree_leaves(self.specs["master"])]
        return err_layout(sgd.tree_leaves(self.lshapes), loc, full, dims)

    def shard(self, state, to=None):
        """This rank's blocks of a whole state (its residual row: its
        pod's row of the one-process (P, width) residual, cut), each
        block copied to ``to`` (a device) as it is cut when given: a
        whole state read lazily (memory-mapped) is never resident."""
        d, r = self.mesh.shape.get("data", 1), self.mesh.coord("data")

        def cut(t, spec):
            dim = shard_dim(spec, self.mesh)
            if to is None:
                return block_of(t, dim, d, r)
            if dim is None or d == 1:
                return t.to(to, copy=True)
            size = t.shape[dim] // d
            part = t.narrow(dim, r * size, size)
            return torch.empty(part.shape, dtype=t.dtype,
                               device=to).copy_(part)

        out = {}
        for k, v in state.items():
            if k in _TREES:
                out[k] = map_blocks(v, self.specs[k], cut)
            elif k == "err":
                p = self.mesh.coord("pod")
                e = err_block(v[p:p + 1], self.err_layout(), d, r)
                out[k] = e if to is None else e.to(to)
            else:
                out[k] = v
        return out

    def lazy(self, state):
        """``state``'s tree with each tensor a function that every rank
        calls, in one order: on rank 0 it gives the whole leaf in host
        memory, elsewhere None.  A cut leaf's blocks are gathered to rank
        0 alone from pod 0's data group (the pods hold the same blocks);
        the residual's rows from every rank, merged into the one-process
        (P, width) rows.  A whole state is never on one rank at once."""
        import torch.distributed as dist

        group, parts = self.mesh.group("data"), self.mesh.shape.get("data", 1)
        pod0 = self.mesh.coord("pod") == 0
        writer = self.mesh.rank == 0

        def leaf(t, spec):
            dim = shard_dim(spec, self.mesh)
            if not pod0:
                return lambda: None
            if dim is None or parts == 1:
                return lambda: (t.detach().to("cpu", copy=True) if writer
                                else None)
            return lambda: gather_to_first(t.detach(), dim, group, parts)

        def err():
            rows = gather_to_first(state["err"].detach(), 0,
                                   dist.group.WORLD, dist.get_world_size())
            if rows is None:
                return None
            layout = self.err_layout()
            return torch.cat([err_merge(list(rows[p * parts:(p + 1) * parts]
                                             .split(1)), layout)
                              for p in range(rows.shape[0] // parts)])

        out = {}
        for k, v in state.items():
            if k in _TREES:
                out[k] = map_blocks(v, self.specs[k], leaf)
            elif k == "err":
                out[k] = err
            else:
                out[k] = v
        return out

    def gather(self, state):
        """The whole state in host memory on rank 0 (the residual as
        one-process rows (P, width)), None on the other ranks; every rank
        takes part (``lazy``)."""
        lazy = self.lazy(state)
        got = iter([f() for f in _callables(lazy, [])])
        return _fill(lazy, got) if self.mesh.rank == 0 else None

    def full_like(self, state):
        """Meta tensors of the whole state's shapes (the residual's
        one-process rows) from a rank's blocks."""
        d = self.mesh.shape.get("data", 1)

        def grow(t, spec):
            dim = shard_dim(spec, self.mesh)
            shape = [s * (d if i == dim else 1) for i, s in
                     enumerate(t.shape)]
            return torch.empty(shape, dtype=t.dtype, device="meta")

        out = {}
        for k, v in state.items():
            if k in _TREES:
                out[k] = map_blocks(v, self.specs[k], grow)
            elif k == "err":
                out[k] = torch.empty(
                    (self.mesh.shape.get("pod", 1), self.err_layout().width),
                    dtype=v.dtype, device="meta")
            else:
                out[k] = v
        return out
