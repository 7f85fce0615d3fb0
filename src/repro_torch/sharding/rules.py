"""Logical-axis -> mesh-axis rule tables, and the N:M group guard.

Counterpart of ``src/repro/sharding/rules.py``: ``TRAIN_RULES``,
``SERVE_BATCH_RULES``, ``SERVE_LONG_RULES``, ``rules_for``,
``spec_to_pspec`` (with its dedupe, divisibility and group-integrity
guards), ``params_pspecs``, ``nm_group_multiples``,
``nm_params_pspecs``, ``pregen_pspecs``, ``assert_nm_unsplit`` (the u4
index plane's per-shard multiple included), ``grad_sync_pspecs``,
``batch_axes``, ``train_input_pspecs`` and ``serve_input_pspecs``, with
the reference's results leaf for leaf; beside them the reference's
``launch.spmd._sanitize_pspec`` and ``sanitize_pspecs``, which the
serve-side resolution and ``sharding.tp`` both use
(``launch.spmd`` re-exports them).

Workloads, as in the reference:
  TRAIN       — FSDP("data") x TP("model"); pure DP across "pod";
  SERVE_BATCH — TP("model") weights, batch over ("pod", "data");
  SERVE_LONG  — as SERVE_BATCH, the cache's sequence over "data".

Types: a spec is a tuple with one entry a dim, each ``None``
(replicated), a mesh axis name, or a tuple of names (the reference's
``PartitionSpec`` as a tuple); a spec tree mirrors a param tree of
dicts and lists, a pre-generated site's spec being a ``PregenOp`` whose
fields are specs.  A mesh is anything with ``.shape``, an ordered
{axis: size}, and ``.axis_names`` (``launch.mesh.Mesh``).  The port's
trees are per layer, so a per-layer leaf's spec has no leading entry
for the reference's "layer" axis, which ``TRAIN_RULES`` never shards:
drop the reference's first entry to compare.

What differs: ``constrain``, ``activation_sharding`` and ``act`` have
no counterpart.  They pin activations onto "model" and onto one SPMD
program's batch for GSPMD to insert collectives at; the port executes
those points as explicit collectives itself: ``sharding.tp`` the
"model" axis of serving (the heads, the KV cache, the FFN hidden, the
vocab-sharded logits), ``sharding.fsdp`` the "data" and "pod" axes of
training (whose "model" axis is ROADMAP item 7, the training side).
``params_shardings`` has no counterpart: there is no ``NamedSharding``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import bdwp
from repro_torch.core.operand import PackedOp, PregenOp, SharedOp

# logical axis -> mesh axis (or tuple, or None = replicated)
TRAIN_RULES = {
    "embed": "data",      # FSDP: shard the width axis of every weight
    "mlp": "model",       # Megatron TP
    "heads": "model",
    "kv": "model",
    "vocab": "model",
    "expert": "model",    # expert parallelism
    "layer": None,
}

SERVE_BATCH_RULES = {
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv": "model",
    "vocab": "model",
    "expert": "model",
    "layer": None,
}

SERVE_LONG_RULES = dict(SERVE_BATCH_RULES)

_PREGEN_FIELDS = ("bp", "ff", "vals", "idx", "mask")


def rules_for(shape_kind: str):
    if shape_kind == "train":
        return TRAIN_RULES
    return SERVE_BATCH_RULES


def is_spec(x) -> bool:
    """Is ``x`` a spec (a tuple of None, names, tuples of names)?"""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def spec_to_pspec(axes: tuple, rules: dict, shape=None, mesh=None,
                  group_multiples: Optional[dict] = None) -> tuple:
    """Logical axes -> a mesh spec with the reference's three guards:

    * dedupe — a mesh axis appears once a spec (stacked MoE weights map
      both "expert" and "mlp" to "model": the first wins, later ones
      are replicated);
    * divisibility — with ``shape`` and ``mesh``, a dim the mesh axes do
      not divide is replicated (hymba's in_proj output of 6482);
    * group integrity — ``group_multiples[i]`` demands the per-shard
      size of dim ``i`` stay a multiple of it; a mesh axis that would
      cut an N:M group is dropped.
    """
    entries, used = [], set()
    for i, ax in enumerate(axes):
        target = rules.get(ax) if ax is not None else None
        if target is not None:
            tgt_axes = target if isinstance(target, tuple) else (target,)
            if any(t in used for t in tgt_axes):
                target = None
            elif shape is not None and mesh is not None:
                size = 1
                for t in tgt_axes:
                    size *= mesh.shape.get(t, 1)
                mult = (group_multiples or {}).get(i, 1)
                if shape[i] % size or (shape[i] // size) % mult:
                    target = None
            if target is not None:
                used.update(tgt_axes)
        entries.append(target)
    return tuple(entries)


def _walk2(fn, spec_node, p_node, path=()):
    """fn(path, spec, leaf) over a spec tree and its param tree."""
    if isinstance(spec_node, dict):
        return {k: _walk2(fn, v, p_node[k], path + (k,))
                for k, v in spec_node.items()}
    if isinstance(spec_node, list):
        return [_walk2(fn, v, p, path) for v, p in zip(spec_node, p_node)]
    return fn(path, spec_node, p_node)


def params_pspecs(specs_tree, rules: dict, params=None, mesh=None):
    """A logical-axis spec tree -> its mesh spec tree; ``params`` (a
    matching tree of tensors, meta ones too) with ``mesh`` enables the
    divisibility guard."""
    if params is None:
        return _walk2(lambda _, ax, __: spec_to_pspec(ax, rules),
                      specs_tree, specs_tree)
    return _walk2(lambda _, ax, p: spec_to_pspec(
        ax, rules, shape=tuple(p.shape), mesh=mesh), specs_tree, params)


# ---------------------------------------------------------------------------
# N:M group integrity
# ---------------------------------------------------------------------------
#
# BDWP prunes in groups of M along a weight's contraction axis (ndim-2)
# and, for BP, its output axis (ndim-1); the packed format stores the N
# survivors of a group contiguously along the compact axis.  A shard
# boundary inside a group would make its top-N selection, or its (vals,
# idx) run, straddle two ranks: the rules never emit such a spec, and
# the resolved specs are asserted against it.


def shard_count(entry, mesh) -> int:
    """How many ways one spec entry cuts its dim on ``mesh``."""
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    size = 1
    for a in axes:
        size *= mesh.shape.get(a, 1)
    return size


def nm_group_multiples(name: str, shape, sp_cfg) -> Optional[dict]:
    """Per-dim per-shard multiples an N:M-prunable weight demands: m
    along the FF axis (ndim-2) and, for BDWP or BP-side methods, the
    BP axis (ndim-1).  None for dense or non-prunable leaves."""
    if sp_cfg is None or getattr(sp_cfg, "is_dense", True):
        return None
    if len(shape) < 2 or not bdwp.should_prune(name, tuple(shape[-2:]),
                                               sp_cfg):
        return None
    gm = {}
    if sp_cfg.prunes_ff_weights():
        gm[len(shape) - 2] = sp_cfg.m
    if sp_cfg.prunes_bp_weights() or sp_cfg.prunes_bp_grads():
        gm[len(shape) - 1] = sp_cfg.m
    return gm or {len(shape) - 2: sp_cfg.m}


def nm_params_pspecs(specs_tree, rules: dict, params, mesh, sp_cfg=None):
    """``params_pspecs`` plus the N:M group guard: every prunable leaf
    (a ``{"w": ...}`` dict's "w" by its dict's name, or a bare expert
    stack, ``bdwp.bare_nm_leaf``) carries ``nm_group_multiples`` into
    ``spec_to_pspec``, so a mesh axis that would split an M-group falls
    back to replicated.  With ``sp_cfg`` None or dense this is
    ``params_pspecs``."""
    if sp_cfg is None or getattr(sp_cfg, "is_dense", True):
        return params_pspecs(specs_tree, rules, params, mesh)

    def walk(spec_node, p_node, path):
        if isinstance(spec_node, dict):
            if "w" in spec_node and is_spec(spec_node["w"]):
                name = "/".join(path)
                out = {}
                for key, ax in spec_node.items():
                    shape = tuple(p_node[key].shape)
                    gm = (nm_group_multiples(name, shape, sp_cfg)
                          if key == "w" else None)
                    out[key] = spec_to_pspec(ax, rules, shape=shape,
                                             mesh=mesh, group_multiples=gm)
                return out
            return {k: walk(v, p_node[k], path + (k,))
                    for k, v in spec_node.items()}
        if isinstance(spec_node, list):
            return [walk(v, p, path) for v, p in zip(spec_node, p_node)]
        name = "/".join(path)
        shape = tuple(p_node.shape)
        gm = (nm_group_multiples(name, shape, sp_cfg)
              if bdwp.bare_nm_leaf(name) else None)
        return spec_to_pspec(spec_node, rules, shape=shape, mesh=mesh,
                             group_multiples=gm)

    return walk(specs_tree, params, ())


def pregen_pspecs(compute_tree, master_pspecs):
    """Specs of a pre-generated compute tree (``optim.sgd.pregen_tree``):
    each ``PregenOp`` site becomes a ``PregenOp`` whose present fields
    (bp, ff or vals/idx, mask) all take the master weight's spec; every
    other leaf its master leaf's.  A mesh axis the guard admitted for w
    (per-shard multiple of M along K) divides Kc = K N/M into whole
    N-runs, so the packed pair keeps the same spec."""
    def walk(c, s):
        if isinstance(c, PregenOp):
            return PregenOp(**{f: (None if getattr(c, f) is None else s)
                               for f in _PREGEN_FIELDS},
                            cfg=c.cfg, idx_bits=c.idx_bits)
        if isinstance(c, dict):
            return {k: walk(v, s[k]) for k, v in c.items()}
        if isinstance(c, list):
            return [walk(v, t) for v, t in zip(c, s)]
        return s

    return walk(compute_tree, master_pspecs)


def assert_nm_unsplit(pspecs_tree, params_tree, mesh, sp_cfg) -> None:
    """Raise AssertionError naming the leaf if a resolved spec splits an
    N:M group: a prunable ``w`` must keep its per-shard size a multiple
    of M along every grouped axis (``nm_group_multiples``), packed
    ``vals``/``idx`` a multiple of N along the compact axis (ndim-2;
    a u4 index plane N/2 bytes for even N, N bytes, two groups, for odd
    N), a BP operand M along its output axis, and a bare expert stack M
    along its last two axes with its leading axes cut evenly.
    ``PregenOp``, ``PackedOp`` and ``SharedOp`` nodes are recognised by
    type, the equivalent legacy dict layouts by their keys."""
    if sp_cfg is None or getattr(sp_cfg, "is_dense", True):
        return

    def check(name, key, spec, shape, multiples: dict):
        for axis, multiple in multiples.items():
            entry = spec[axis] if axis < len(spec) else None
            shards = shard_count(entry, mesh)
            if shape[axis] % shards or (shape[axis] // shards) % multiple:
                raise AssertionError(
                    f"N:M group split: {name}/{key} dim {axis} (size "
                    f"{shape[axis]}) sharded {shards}-way over {entry!r}: "
                    f"per-shard size must be a multiple of {multiple}")

    def field(node, key):
        if isinstance(node, dict):
            return node.get(key)
        return getattr(node, key, None)

    def idx_multiple(spec_node, key) -> int:
        if key == "idx" and getattr(spec_node, "idx_bits", 8) == 4:
            return sp_cfg.n // 2 if sp_cfg.n % 2 == 0 else sp_cfg.n
        return sp_cfg.n

    def check_pregen(name, spec_node, p_node):
        if sp_cfg.prunes_ff_weights():
            if is_spec(field(spec_node, "ff")):
                shape = tuple(field(p_node, "ff").shape)
                check(name, "ff", field(spec_node, "ff"), shape,
                      {len(shape) - 2: sp_cfg.m})
            for key in ("vals", "idx"):
                if is_spec(field(spec_node, key)):
                    shape = tuple(field(p_node, key).shape)
                    check(name, key, field(spec_node, key), shape,
                          {len(shape) - 2: idx_multiple(spec_node, key)})
        if sp_cfg.prunes_bp_weights() and is_spec(field(spec_node, "bp")):
            shape = tuple(field(p_node, "bp").shape)
            check(name, "bp", field(spec_node, "bp"), shape,
                  {len(shape) - 1: sp_cfg.m})

    def walk(spec_node, p_node, path):
        name = "/".join(path)
        if isinstance(spec_node, PregenOp):
            check_pregen(name, spec_node, p_node)
            return
        if isinstance(spec_node, PackedOp):
            for key in ("vals", "idx"):
                if is_spec(field(spec_node, key)):
                    shape = tuple(field(p_node, key).shape)
                    check(name, key, field(spec_node, key), shape,
                          {len(shape) - 2: idx_multiple(spec_node, key)})
            return
        if isinstance(spec_node, SharedOp):
            if is_spec(spec_node.vals):
                shape = tuple(p_node.vals.shape)
                if len(shape) >= 2:
                    check(name, "vals", spec_node.vals, shape,
                          {len(shape) - 2: sp_cfg.n})
            return
        if is_spec(spec_node):
            gm = (nm_group_multiples(name, tuple(p_node.shape), sp_cfg)
                  if bdwp.bare_nm_leaf(name) else None)
            if gm:
                shape = tuple(p_node.shape)
                for i in range(len(shape) - 2):
                    gm.setdefault(i, 1)
                check(name, "leaf", spec_node, shape, gm)
            return
        if isinstance(spec_node, list):
            for v, p in zip(spec_node, p_node):
                walk(v, p, path)
            return
        if isinstance(spec_node, dict):
            if "bp" in spec_node and ("ff" in spec_node
                                      or "vals" in spec_node):
                check_pregen(name, spec_node, p_node)
                return
            if "w" in spec_node and is_spec(spec_node["w"]):
                shape = tuple(p_node["w"].shape)
                gm = nm_group_multiples(name, shape, sp_cfg)
                if gm:
                    check(name, "w", spec_node["w"], shape, gm)
                return
            if "vals" in spec_node and is_spec(spec_node["vals"]):
                v_rank = len(p_node["vals"].shape)
                for key in ("vals", "idx"):
                    if key in spec_node and is_spec(spec_node[key]) \
                            and len(p_node[key].shape) == v_rank >= 2:
                        shape = tuple(p_node[key].shape)
                        check(name, key, spec_node[key], shape,
                              {len(shape) - 2: sp_cfg.n})
                return
            for k, v in spec_node.items():
                walk(v, p_node[k], path + (k,))

    walk(pspecs_tree, params_tree, ())


def _entry(axes: tuple):
    """One spec entry of mesh axes: a lone name as itself (the
    reference's ``PartitionSpec`` stores ("data",) as "data")."""
    return axes[0] if len(axes) == 1 else axes


def grad_sync_pspecs(mesh) -> dict:
    """The compressed sync's residual: (n_pods, T_loc * S), row p on pod
    p's ranks, the width laid out as S rank-local slabs along the
    intra-pod axes; replicated rows on a pod-less mesh."""
    pod = "pod" if "pod" in mesh.axis_names else None
    intra = tuple(a for a in mesh.axis_names if a != "pod")
    return {"err": (pod, _entry(intra)) if intra else (pod, None)}


def batch_axes(mesh):
    """The data-parallel axes of the activation batch dim on ``mesh``."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_entry(mesh):
    """``batch_axes`` as one spec entry."""
    return _entry(batch_axes(mesh))


# ---------------------------------------------------------------------------
# Input / cache specs per workload
# ---------------------------------------------------------------------------


def train_input_pspecs(input_specs: dict, mesh):
    dp = batch_entry(mesh)
    out = {}
    for name in input_specs:
        if name in ("tokens", "labels"):
            out[name] = (dp, None)
        elif name in ("frames", "prefix_embeds"):
            out[name] = (dp, None, None)
        else:
            out[name] = ()
    return out


def _cache_spec(name: str, shape, bp, long_context: bool, tp: int):
    """One per-layer cache leaf's spec (the reference's ``cache_spec``
    for an unstacked leaf: its stacked leaves add a leading None)."""
    rank = len(shape)
    seq_ax = "data" if long_context else None
    if name in ("k", "v"):        # (B, S, Hkv, D)
        return (bp, seq_ax, "model" if shape[rank - 2] % tp == 0 else None,
                None)
    if name in ("ckv", "kpe"):    # (B, S, dim)
        return (bp, seq_ax, None)
    if name == "state":           # (B, H, N, Pd)
        return (bp, "model" if shape[rank - 3] % tp == 0 else None, None,
                None)
    if name == "conv":            # (B, K-1, C)
        return (bp, None, "model" if shape[rank - 1] % tp == 0 else None)
    return (None,) * rank         # "pos" (a 0-d cursor: ()) and the rest


def serve_input_pspecs(input_specs: dict, mesh, *, long_context: bool):
    """Decode and prefill inputs; a cache (the port's ``{"layers":
    [...], "prelude": ...}``) leaf by leaf, by its name."""
    dp = batch_entry(mesh)
    bp = None if long_context else dp
    tp = mesh.shape.get("model", 1)

    def cache_tree(node, key):
        if isinstance(node, dict):
            return {k: cache_tree(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [cache_tree(v, key) for v in node]
        return _cache_spec(key, tuple(getattr(node, "shape", ())), bp,
                           long_context, tp)

    out = {}
    for name, leaf in input_specs.items():
        if name == "cache":
            out[name] = cache_tree(leaf, None)
        elif name in ("token", "tokens"):
            out[name] = (bp, None)
        elif name in ("frames", "prefix_embeds", "enc_out"):
            out[name] = (bp, None, None)
        else:
            out[name] = ()
    return out


def _sanitize_pspec(ps: tuple, shape, mesh) -> tuple:
    """Drop the spec entries whose mesh-axis product does not divide
    their dim (odd slot counts, batch-1 prefill): replicate them."""
    return tuple(None if entry is None or shape[i] % shard_count(
        entry, mesh) else entry for i, entry in enumerate(ps))


def sanitize_pspecs(pspecs, tree, mesh):
    """``_sanitize_pspec`` over a spec tree and its tree of tensors
    (meta ones too; a leaf without a shape, such as a cache's ``pos``
    cursor, has the empty spec)."""
    if isinstance(pspecs, dict):
        return {k: sanitize_pspecs(v, tree[k], mesh)
                for k, v in pspecs.items()}
    if isinstance(pspecs, list):
        return [sanitize_pspecs(v, t, mesh) for v, t in zip(pspecs, tree)]
    return _sanitize_pspec(pspecs, tuple(getattr(tree, "shape", ())), mesh)
