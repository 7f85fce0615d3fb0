"""WUVE analogue: momentum SGD with SR-STE decay and N:M pre-generation.

Counterpart of ``src/repro/optim/sgd.py`` (``SGDConfig``,
``lr_schedule``, ``init_state``, ``_pregen_masks``/``_pregen_leaf``,
``pregen_tree``, ``pregen_grads``, ``update``).
State per parameter: fp32 ``master`` and ``momentum``.  With
``pregen=True`` each update also writes the next step's compute tree
(paper Fig. 11c): every prunable weight (``bdwp.pregen_site``) becomes a
``PregenOp`` holding its bf16 BP operand, its FF operand (SORE-packed
``vals``/``idx`` with ``pack``) and its SR-STE decay mask, all from the
masks of the fp32 master: one selection for element masks
(``nm_mask_pair``), one ``nm_mask_shared`` per direction for shared
granularity, one ``nm_mask_transposable`` for a transposable config,
whose one mask serves FF, BP and the decay (its operand keeps ``bp``
and, with ``pack``, the packed pair; no ``ff``).  Every other leaf
becomes its bf16 copy: the norms, a QKV projection's 1-D bias (never a
site) and the embedding table, which a tied head reads as its logits
weight too (``embed`` is excluded), so its gradient sums both uses.
With ``pregen=False`` (the legacy dataflow,
whose FF and BP re-derive their masks inside the model) every leaf takes
the elementwise path, the decay mask is ``nm_mask`` of the pre-update
master along the FF axis (the BP axis for sdwp) whatever the
granularity, as in the reference, and no compute tree is returned: the
reference's is the plain bf16 cast of the new master, which its step
drops and the next step casts again (``train.step`` casts once, at the
step that reads it).

The fused path: the element-granularity srste/bdwp sites of a
pre-generating step are updated together by
``kernels.ops.fused_update_sites`` (one launch of the ``fused_update``
kernel on the card, its plain version site by site on the CPU), which
applies the decay from the mask of the pre-update master (bitwise the
stored mask: both select on the same fp32 master) and writes the packed
FF operand, the FF mask and the bf16 BP operand (for bdwp the
output-axis ``nm_mask`` of the new master, as the reference's
``pallas_upd`` derives it in jnp).  Shared and transposable sites stay
off it, as in the reference (the kernel derives one-sided element
masks), and take the elementwise path with the rest.

A conv master (H, W, I, O) takes the same kernel on its (H*W*I, O) view:
its m-groups of rows are the reference's groups along I, which is what
``pallas_upd`` builds by moving I last.  An MoE expert stack (E, K, F),
a bare-array site (``bdwp.bare_nm_leaf``), takes it on its (E*K, F)
view: K is a multiple of m, so no m-group straddles two experts, and
its masks are per expert along K and F (axes 1 and 2), as the
reference's along the last two axes of its (L, E, K, F) leaf.

What differs:
  * trees are the port's per-layer trees (``"blocks"`` is a list, as
    are an encoder-decoder's ``"enc_blocks"`` and ``"dec_blocks"``), and
    leaf names skip the list index, so a name is the reference's
    (``blocks/attn/q_proj/w``); shapes are per layer, so a leaf's shape
    is its logical shape;
  * there is no ``use_pallas`` flag: the tensors' device picks kernel
    or plain version, and every eligible site takes the fused path;
  * ``update`` consumes its state: master and momentum are updated in
    place (the reference donates them), which saves several 2.5 GB
    temporaries on the embed and lm_head tables and a new copy of every
    site's master and momentum;
  * ``step`` is a Python int;
  * ``update`` reads each leaf's stored decay mask from the same
    position of ``prev_compute`` (the trees are per layer, so the
    reference's name -> mask dict, ``stored_decay_masks``, would need a
    layer index).
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch
from torch.profiler import record_function

from repro_torch.core import bdwp
from repro_torch.core.operand import PregenOp
from repro_torch.core.sparsity import (SparsityConfig, nm_mask,
                                       nm_mask_pair, nm_mask_shared,
                                       nm_mask_transposable,
                                       nm_pack_from_mask, nm_unpack_n)
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.01


def lr_schedule(cfg: SGDConfig, step: int) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: a 0-d fp32
    CPU tensor, computed with the reference's fp32 ops in its order."""
    step = torch.tensor(float(step), dtype=torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def tree_map(fn, *trees, path=()):
    """fn(name, *leaves) over same-shaped trees of dicts and lists; the
    name joins dict keys with "/" and skips list indices, so a per-layer
    leaf carries the reference's stacked name."""
    node = trees[0]
    if isinstance(node, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in node}
    if isinstance(node, list):
        return [tree_map(fn, *(t[i] for t in trees), path=path)
                for i in range(len(node))]
    return fn("/".join(path), *trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in ``tree_map`` order."""
    out = []
    tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


def init_state(params):
    """fp32 master (the params themselves where they are fp32 already:
    the state takes them over), zero momentum, step 0."""
    return {
        "master": tree_map(lambda _, p: p.to(torch.float32), params),
        "momentum": tree_map(
            lambda _, p: torch.zeros_like(p, dtype=torch.float32), params),
        "step": 0,
    }


# ---------------------------------------------------------------------------
# Pre-generation: fp32 master -> the bf16 compute tree FF/BP consume
# ---------------------------------------------------------------------------


def _pregen_masks(w: torch.Tensor, sp_cfg: SparsityConfig):
    """(ff_mask, bp_mask, decay_mask) of one fp32 weight; the FF and BP
    masks of an element-granularity bdwp weight come from one selection
    (``nm_mask_pair``), a transposable config's three are one mask;
    unused directions are None."""
    n, m = sp_cfg.n, sp_cfg.m
    ff_ax, bp_ax = w.ndim - 2, w.ndim - 1
    if sp_cfg.transposable:
        with record_function("sgd/nm_mask_transposable"):
            tm = nm_mask_transposable(w, n, m)
        return tm, tm, tm
    shared = sp_cfg.granularity == "shared"

    def one(axis, share_axis):
        if shared:
            return nm_mask_shared(w, n, m, axis, share_axis, sp_cfg.tile)
        return nm_mask(w, n, m, axis=axis)

    ff_mask = bp_mask = None
    if sp_cfg.prunes_ff_weights() and sp_cfg.prunes_bp_weights():
        if shared:
            ff_mask, bp_mask = one(ff_ax, bp_ax), one(bp_ax, ff_ax)
        else:
            ff_mask, bp_mask = nm_mask_pair(w, n, m, ff_ax, bp_ax)
    elif sp_cfg.prunes_ff_weights():
        ff_mask = one(ff_ax, bp_ax)
    elif sp_cfg.prunes_bp_weights():
        bp_mask = one(bp_ax, ff_ax)
    decay_mask = bp_mask if sp_cfg.method == "sdwp" else ff_mask
    return ff_mask, bp_mask, decay_mask


def _pregen_leaf(w: torch.Tensor, sp_cfg: SparsityConfig,
                 pack: bool) -> PregenOp:
    """fp32 weight -> PregenOp{ff | (vals, idx), bp, mask}, or for a
    transposable config PregenOp{bp, (vals, idx) with ``pack``, mask}.
    Masking commutes with the bf16 cast, and the selection scores fp32
    master.  Only element-granularity FF operands are packed."""
    ff_mask, bp_mask, decay_mask = _pregen_masks(w, sp_cfg)
    bp = torch.where(bp_mask, w, 0.0) if bp_mask is not None else w
    if sp_cfg.transposable:
        bp16 = bp.to(torch.bfloat16)
        if pack:
            vals, idx = nm_pack_from_mask(bp16, ff_mask, sp_cfg.n, sp_cfg.m,
                                          axis=w.ndim - 2)
            return PregenOp(bp=bp16, vals=vals, idx=idx, mask=decay_mask,
                            cfg=sp_cfg, idx_bits=8)
        return PregenOp(bp=bp16, mask=decay_mask, cfg=sp_cfg)
    ff = torch.where(ff_mask, w, 0.0) if ff_mask is not None else w
    ff16 = ff.to(torch.bfloat16)
    if pack and ff_mask is not None and sp_cfg.granularity == "element":
        vals, idx = nm_pack_from_mask(ff16, ff_mask, sp_cfg.n, sp_cfg.m,
                                      axis=w.ndim - 2)
        return PregenOp(bp=bp.to(torch.bfloat16), vals=vals, idx=idx,
                        mask=decay_mask, cfg=sp_cfg, idx_bits=8)
    return PregenOp(bp=bp.to(torch.bfloat16), ff=ff16, mask=decay_mask,
                    cfg=sp_cfg)


def shapes_of(tree):
    """The tree of its leaves' shapes (tuples)."""
    return tree_map(lambda _, x: tuple(x.shape), tree)


def pregen_tree(master, sp_cfg: SparsityConfig, *, pack: bool = False,
                bare_sites: bool = True, lshapes=None):
    """The pre-generated compute tree of an fp32 master tree: sites
    become PregenOp leaves, other float leaves their bf16 copies.

    ``bare_sites=False`` leaves the bare-array MoE expert stacks as
    plain bf16 copies, the structure of the reference's dict-sites-only
    compute trees (``train.step.restore_with_pregen`` reads it).
    ``lshapes``: a tree of each leaf's logical (unsharded) shape, which
    picks the sites, for a master of rank-local blocks
    (``sharding.fsdp``); by default the leaves' own shapes."""
    def leaf(name, w, lshape):
        if (bare_sites or not bdwp.bare_nm_leaf(name)) and \
                bdwp.pregen_site(name, lshape, sp_cfg):
            return _pregen_leaf(w.to(torch.float32), sp_cfg, pack)
        if w.is_floating_point():
            return w.to(torch.bfloat16)
        return w

    return tree_map(leaf, master,
                    shapes_of(master) if lshapes is None else lshapes)


def diff_leaves(compute) -> list:
    """The float leaves of a compute tree that the step differentiates,
    in ``tree_map`` order: each PregenOp's ``bp`` and every other float
    leaf (``vals``/``ff`` get no gradient)."""
    out = []
    for leaf in tree_leaves(compute):
        if bdwp.is_pregen(leaf):
            out.append(leaf.bp)
        elif leaf.is_floating_point():
            out.append(leaf)
    return out


def pregen_grads(compute, grads):
    """The master-shaped gradient tree from the gradients of
    ``diff_leaves(compute)``, in that order: a site's gradient is its
    ``bp``'s, the dense straight-through WU gradient."""
    it = iter(grads)
    return tree_map(lambda _, leaf: next(it), compute)


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------


class _Pending(typing.NamedTuple):
    """A fused site between the two passes of ``update``: its place in
    the list handed to ``ops.fused_update_sites``, its master shape."""
    index: int
    shape: tuple


def update(state, grads, opt_cfg: SGDConfig, sp_cfg: SparsityConfig, *,
           prev_compute=None, pregen: bool = True, pack: bool = False,
           lshapes=None):
    """One optimizer step: (new_state, compute tree).

    ``grads`` is master-shaped (``pregen_grads``).  With ``pregen`` the
    SR-STE decay uses the mask stored in ``prev_compute`` (the one FF/BP
    just consumed; re-derived from master where there is none) and the
    compute tree is the next step's pre-generated operands; without it
    the decay mask is re-derived from master and the compute tree is
    None (the reference's would be the bf16 cast of the new master).
    Master and momentum, and the fp32 gradients of non-site leaves, are
    updated in place.

    ``lshapes`` (a tree of logical shapes, ``pregen_tree``'s) lets the
    state be a rank's blocks of a sharded one (``sharding.fsdp``): the
    sites and the decay are picked by the logical shapes, and each
    block, a site of its own, is updated where it is.  Where no shard
    cuts an N:M group (``sharding.rules.assert_nm_unsplit``) every
    output is bitwise the block's slice of the unsharded update.
    """
    lr = float(lr_schedule(opt_cfg, state["step"]))
    n, m = sp_cfg.n, sp_cfg.m

    fused = []   # (w, g, v) (K, F) views of the fused sites, tree order

    def fused_site(w, g, v):
        # the kernel groups rows of a (K, F) master along K; a conv master
        # (H, W, I, O) is viewed as (H*W*I, O), whose groups of m rows are
        # the reference's groups along I as long as m divides I
        shape, ff_ax = w.shape, w.ndim - 2
        if shape[ff_ax] % m:
            raise ValueError(f"fused update of {tuple(shape)}: contraction "
                             f"axis {shape[ff_ax]} is not a multiple of m={m}")
        f = shape[-1]
        fused.append((w.view(-1, f), g.reshape(-1, f), v.view(-1, f)))
        return _Pending(len(fused) - 1, tuple(shape))

    def fused_leaf(out, shape):
        nw, nv, vals, idx, bp, ff_mask = out
        vals = vals.view(*shape[:-2], -1, shape[-1])
        idx = idx.view(*shape[:-2], -1, shape[-1])
        common = dict(bp=bp.view(shape), mask=ff_mask.view(shape),
                      cfg=sp_cfg)
        if pack:
            leaf = PregenOp(vals=vals, idx=idx, idx_bits=8, **common)
        else:
            ff = nm_unpack_n(vals, idx, n, m, axis=len(shape) - 2)
            leaf = PregenOp(ff=ff, **common)
        return nw.view(shape), nv.view(shape), leaf

    def elementwise_upd(name, w, g, v, prev, site, lshape):
        # one rounding per op, in the reference's order: g + wd*w, then
        # + lam*where(mask, 0, w); mu*v + g; w - lr*v
        g = g.to(torch.float32)
        g.add_(w * opt_cfg.weight_decay)
        if (not sp_cfg.is_dense and sp_cfg.lam > 0.0
                and bdwp.decays(name, lshape, sp_cfg)
                and sp_cfg.method in ("srste", "bdwp", "sdwp")):
            if bdwp.is_pregen(prev) and prev.mask is not None:
                mask = prev.mask
            else:   # no stored mask: re-derive it from master
                axis = (bdwp.bp_group_axis(lshape) if sp_cfg.method == "sdwp"
                        else bdwp.ff_group_axis(lshape))
                mask = nm_mask(w, n, m, axis=axis)
            g.add_(torch.where(mask, 0.0, w) * sp_cfg.lam)
        v.mul_(opt_cfg.momentum).add_(g)
        w.sub_(v * lr)
        if not pregen:
            return w, v, None
        comp = _pregen_leaf(w, sp_cfg, pack) if site else w.to(torch.bfloat16)
        return w, v, comp

    def upd(name, w, g, v, prev, lshape):
        site = pregen and bdwp.pregen_site(name, lshape, sp_cfg)
        if (site and sp_cfg.method in ("srste", "bdwp")
                and sp_cfg.granularity == "element"
                and not sp_cfg.transposable):
            # the kernel derives one-sided element masks: shared and
            # transposable sites stay on the elementwise path
            return fused_site(w, g, v)
        return elementwise_upd(name, w, g, v, prev, site, lshape)

    # two passes: the elementwise leaves and the list of fused sites,
    # then one fused_update_sites over all sites, then their PregenOps
    prev = (prev_compute if pregen and prev_compute is not None
            else state["master"])
    outs = tree_map(upd, state["master"], grads, state["momentum"], prev,
                    shapes_of(state["master"]) if lshapes is None
                    else lshapes)
    done = ops.fused_update_sites(
        fused, lr, opt_cfg.momentum, opt_cfg.weight_decay, sp_cfg.lam, n, m,
        "bdwp" if sp_cfg.prunes_bp_weights() else "srste", inplace=True)
    outs = tree_map(lambda _, o: fused_leaf(done[o.index], o.shape)
                    if isinstance(o, _Pending) else o, outs)
    master, momentum, compute = (tree_map(lambda _, o, i=i: o[i], outs)
                                 for i in range(3))
    return ({"master": master, "momentum": momentum,
             "step": state["step"] + 1}, compute if pregen else None)
