"""BDWP pruning policy: which weights are N:M-pruned and packed.

Counterpart of ``src/repro/core/bdwp.py``: the policy (``serve_packable``,
``ff_group_axis``, ``bp_group_axis``, ``should_prune``, ``pick_cfg``),
the pre-generation sites (``bare_nm_leaf``, ``decays``, ``pregen_site``,
``is_pregen``) and shared-pattern serving packing (``shared_ff_pack``,
``pack_tree_shared``, with its ``pspecs=``), with the same rules.  Not
ported: the deprecated ``nm_linear`` / ``packed_shared_apply`` shims, and
``pregen_site``'s ``bare=False`` (the reference's recognition of
checkpoints written before MoE pre-generation, which the port never
wrote).  A bias (``.../b``, 1-D) is never pruned, packed or a site; a
tied head has no ``lm_head`` leaf, and its table is ``embed``'s,
excluded by name.  The port's trees are per layer, so an MoE expert
stack is (E, K, F): ``ff_group_axis`` gives K and ``bp_group_axis`` F,
the axes the reference's stacked (L, E, K, F) leaf groups along once
its layer axis is dropped.
"""

from __future__ import annotations

import re

import torch

from repro_torch.core.sparsity import DENSE, SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def serve_packable(name: str, lshape, cfg: SparsityConfig) -> bool:
    """FF-direction packing eligibility (serving reads only w_FF); the
    logits head stays dense, as in training."""
    if cfg.is_dense or len(lshape) != 2:
        return False
    for frag in (*cfg.excluded, "lm_head", "k_up", "v_up"):
        if re.search(frag, name):
            return False
    k = lshape[0]
    return k % cfg.m == 0 and k >= 2 * cfg.m


def shared_ff_pack(w: torch.Tensor, cfg: SparsityConfig):
    """w (K, F) -> (vals (Kc, F) in w's dtype, idx (Kc,) int32 absolute
    K rows, ascending): one N:M row pattern for every column, the top n
    of the fp32 |w| row sums in each group of m rows (``ops.nm_compact``
    on the (1, K) score row; the lower row wins a tie)."""
    score = w.abs().to(torch.float32).sum(1)
    _, offsets = ops.nm_compact(score[None], cfg.n, cfg.m)
    idx = ops.group_rows(offsets[0], cfg.n, cfg.m)
    return w.index_select(0, idx), idx


def pack_tree_shared(params, cfg: SparsityConfig, *, device=None,
                     pspecs=None):
    """Transform a param tree for shared-pattern serving: every
    ``{"w": (K, F)}`` leaf-dict that ``serve_packable`` admits becomes
    ``{"w": operand.SharedOp(vals, idx, K)}`` (a bias is carried over),
    and every leaf lies on ``device`` (the card unless the caller names
    another; a tree of meta tensors stays meta and gives the shapes
    alone).  The port's blocks are per layer, so every weight is 2-D.

    With ``pspecs`` (a matching tree of spec tuples), returns (packed
    tree, packed specs) transformed alike: ``vals`` keep w's spec,
    ``idx`` drops its feature entry, as the reference's."""
    from repro_torch.core.operand import SharedOp   # operand imports bdwp

    if not _is_meta(params):
        device = resolve_device(device)

    def pack(w):
        if w.is_meta:
            kc = w.shape[0] // cfg.m * cfg.n
            return SharedOp(torch.empty((kc, w.shape[1]), dtype=w.dtype,
                                        device="meta"),
                            torch.empty((kc,), dtype=torch.int32,
                                        device="meta"), w.shape[0])
        return SharedOp(*shared_ff_pack(w, cfg), w.shape[0])

    def move(t):
        return t if t.is_meta else t.to(device)

    def walk(node, spec, path):
        if isinstance(node, dict) and "w" in node:
            w = move(node["w"])
            if serve_packable("/".join(path), tuple(w.shape[-2:]), cfg):
                new = {"w": pack(w)}
                new_spec = None if spec is None else {
                    "w": SharedOp(spec["w"], tuple(spec["w"][:-1]))}
                if "b" in node:
                    new["b"] = move(node["b"])
                    if spec is not None:
                        new_spec["b"] = spec["b"]
                return new, new_spec
            return {k: move(v) for k, v in node.items()}, spec
        if isinstance(node, dict):
            out = {k: walk(v, None if spec is None else spec[k],
                           path + (k,)) for k, v in node.items()}
            return ({k: v[0] for k, v in out.items()},
                    None if spec is None else
                    {k: v[1] for k, v in out.items()})
        if isinstance(node, list):
            out = [walk(v, None if spec is None else spec[i], path)
                   for i, v in enumerate(node)]
            return ([v[0] for v in out],
                    None if spec is None else [v[1] for v in out])
        return move(node), spec

    packed, packed_specs = walk(params, pspecs, ())
    return packed if pspecs is None else (packed, packed_specs)


def _is_meta(tree) -> bool:
    if isinstance(tree, dict):
        return all(_is_meta(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_is_meta(v) for v in tree)
    return tree.is_meta


def ff_group_axis(shape) -> int:
    """FF-pass N:M group axis (the contraction axis) for a weight of this
    rank: (K, F) -> 0; (L, K, F) -> 1; higher ranks -> rank-2."""
    if len(shape) == 2:
        return 0
    if len(shape) == 3:
        return 1
    return len(shape) - 2


def bp_group_axis(shape) -> int:
    """BP-pass group axis (output features): always the last axis."""
    return len(shape) - 1


def should_prune(name: str, shape, cfg: SparsityConfig) -> bool:
    """Prune every linear weight except excluded names, provided every
    axis the method groups along tiles into M-groups."""
    if cfg.is_dense:
        return False
    if len(shape) < 2:
        return False
    for frag in cfg.excluded:
        if re.search(frag, name):
            return False
    axes = []
    if cfg.prunes_ff_weights():
        axes.append(ff_group_axis(shape))
    if cfg.prunes_bp_weights() or cfg.prunes_bp_grads():
        axes.append(bp_group_axis(shape))
    if not axes:
        axes.append(ff_group_axis(shape))
    return all(shape[a] % cfg.m == 0 and shape[a] >= 2 * cfg.m
               for a in axes)


def pick_cfg(name: str, shape, cfg: SparsityConfig) -> SparsityConfig:
    """Per-parameter effective config (dense when excluded)."""
    return cfg if should_prune(name, shape, cfg) else DENSE


# Weights that pass ``should_prune`` but are consumed directly, not
# through ``nm_apply``: the logits head.  They are never pre-generated
# and SR-STE never decays them.
_DIRECT_CONSUMED = ("lm_head",)


def decays(name: str, lshape, cfg: SparsityConfig) -> bool:
    """Does SR-STE's sparse-refined decay apply to this parameter?"""
    if any(re.search(frag, name) for frag in _DIRECT_CONSUMED):
        return False
    return should_prune(name, lshape, cfg)


# Bare-array prunable leaves: weights stored as tensors rather than
# ``{"w": ...}`` leaf-dicts, the MoE expert stacks (E, K, F) and the
# shared-expert matrices of ``models.moe``, whose consumer
# (``moe._nm_mm``) takes a pre-generated operand in their place.  The
# FFN leaves of the same names are dict sites (".../w_gate/w").
_BARE_NM_BASENAMES = ("w_gate", "w_up", "w_down")


def bare_nm_leaf(name: str) -> bool:
    """Is this the tree name of a bare-array N:M-consumed weight leaf?"""
    return name.rsplit("/", 1)[-1] in _BARE_NM_BASENAMES


def pregen_site(name: str, lshape, cfg: SparsityConfig) -> bool:
    """Is this master leaf (a ``{"w": ...}`` weight, tree name ending in
    ``/w``, or a bare MoE leaf, ``bare_nm_leaf``) replaced by a
    pre-generated operand (``core.operand.PregenOp``)?"""
    if not (name.endswith("/w") or bare_nm_leaf(name)):
        return False
    if cfg.is_dense or not (cfg.prunes_ff_weights()
                            or cfg.prunes_bp_weights()):
        return False
    return decays(name, lshape, cfg)


def is_pregen(node) -> bool:
    """Is ``node`` a pre-generated operand leaf of a compute tree?"""
    from repro_torch.core.operand import PregenOp   # operand imports bdwp

    return isinstance(node, PregenOp)
