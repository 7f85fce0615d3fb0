"""Load the JAX reference's parameter and train-state trees into the
port's layout.

No reference counterpart.  ``params_from_jax`` takes the reference's
``transformer_lm.init``, ``encdec.init`` or ``convnets.*_init`` tree, and
``train_state_from_jax`` its train state, with every array already
turned into numpy (``jax.tree.map(np.asarray, tree)``), so this module
needs neither JAX nor ``repro``:

  * leaves under ``"blocks"`` (an encoder-decoder: ``"enc_blocks"`` and
    ``"dec_blocks"``) are stacked along a leading layer axis (L, …) and
    become a list of L per-layer dicts, pre-generated and packed
    operands included; a tree without them (the convnets) keeps its
    structure;
  * ``{"w": (K, F)}`` leaf-dicts keep their layout (``x @ w``), and so
    do HWIO conv weights and their pre-generated operands (a
    transposable one may hold ``bp`` alone, or ``bp`` and the packed
    pair);
  * a QKV bias (``{"w", "b"}`` leaf-dicts, the bias stacked (L, F))
    becomes each layer's (F,) bias; a tied tree (no ``lm_head``) stays
    tied; the layer ``pattern`` of a config does not enter the tree
    (every block has the same leaves), so gemma3's stacked blocks
    convert as any other;
  * integer leaves (ResNet's ``_meta``) keep their dtype;
  * a packed operand (the reference's ``PackedOp``, recognised by its
    ``vals``, ``idx``, ``idx_bits`` and ``cfg`` attributes) becomes the
    port's ``PackedOp`` with the same (Kc, F) vals and u8 or u4 idx;
  * a shared-pattern operand (the reference's ``SharedOp`` from
    ``bdwp.pack_tree_shared``: ``vals`` and ``idx`` with no ``cfg``)
    becomes the port's ``SharedOp`` with the same (Kc, F)
    vals and (Kc,) int32 rows;
  * bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) are carried bit for
    bit;
  * the error-feedback residual ``err`` of a compressed train state,
    (n_pods, width) in the reference's slab layout, becomes the port's
    (``err_from_jax``; ``err_to_jax`` is the inverse).  The reference's
    slab holds the compressible leaves in JAX's flatten order (dict keys
    sorted at every level), a layer-stacked leaf as its L layers in a
    row; the port's holds them in ``sgd.tree_leaves`` order of its
    per-layer tree, a layer stack of ragged per-layer leaves as one unit
    (``optim.compress.plan_sync``).  Both pad with zeros to whole
    m-groups.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.operand import PackedOp, PregenOp, SharedOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.optim import compress as C
from repro_torch.optim import sgd


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bfloat16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_packed(node) -> bool:
    return all(hasattr(node, a) for a in ("vals", "idx", "idx_bits", "cfg"))


def _is_shared(node) -> bool:
    return (all(hasattr(node, a) for a in ("vals", "idx", "fields"))
            and getattr(node, "cfg", None) is None)


def _is_pregen(node) -> bool:
    return all(hasattr(node, a) for a in ("bp", "fields", "cfg"))


def _sparsity_config(cfg) -> SparsityConfig:
    return SparsityConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(SparsityConfig)})


def _convert(node, device, layer):
    """``layer`` is None outside the stacked blocks, else the layer to take."""
    if isinstance(node, dict):
        return {k: _convert(v, device, layer) for k, v in node.items()}
    if _is_pregen(node):
        def take(a):
            if a is None:
                return None
            a = np.asarray(a)
            return tensor_from_numpy(a if layer is None else a[layer], device)

        return PregenOp(bp=take(node.bp), ff=take(node.ff),
                        vals=take(node.vals), idx=take(node.idx),
                        mask=take(node.mask),
                        cfg=_sparsity_config(node.cfg),
                        idx_bits=node.idx_bits)
    if _is_packed(node) or _is_shared(node):
        vals, idx = np.asarray(node.vals), np.asarray(node.idx)
        if layer is not None:
            vals, idx = vals[layer], idx[layer]
        vals, idx = (tensor_from_numpy(vals, device),
                     tensor_from_numpy(idx, device))
        if _is_shared(node):
            return SharedOp(vals, idx)
        return PackedOp(vals, idx, _sparsity_config(node.cfg), node.idx_bits)
    a = np.asarray(node)
    return tensor_from_numpy(a if layer is None else a[layer], device)


def _n_layers(node) -> int:
    if isinstance(node, dict):
        return _n_layers(next(iter(node.values())))
    if _is_pregen(node):
        return np.asarray(node.bp).shape[0]
    if _is_packed(node) or _is_shared(node):
        return np.asarray(node.vals).shape[0]
    return np.asarray(node).shape[0]


STACKS = ("blocks", "enc_blocks", "dec_blocks")   # layer-stacked subtrees


def params_from_jax(tree, *, device=None):
    """The reference's (stacked) param tree as the port's per-layer tree,
    the block lists after the other keys (the order the compressed
    sync's residual columns follow, ``optim.compress``)."""
    device = resolve_device(device)
    out = {k: _convert(v, device, None) for k, v in tree.items()
           if k not in STACKS}
    for k in STACKS:
        if k in tree:
            out[k] = [_convert(tree[k], device, i)
                      for i in range(_n_layers(tree[k]))]
    return out


def train_state_from_jax(state, *, device=None, m=None):
    """The reference's train state (``master``, ``momentum``, ``step``,
    the pre-generated ``compute`` tree of any mask kind when it has one,
    none on the legacy dataflow, and, when it has one, the EF residual
    ``err``) as the port's per-layer state.  The residual's m-groups are
    those of the compute tree's sparsity config, or ``m`` for a state
    without pre-generated operands."""
    device = resolve_device(device)
    out = {k: params_from_jax(state[k], device=device)
           for k in ("master", "momentum", "compute") if k in state}
    out["step"] = int(np.asarray(state["step"]))
    if "err" in state:
        ms = [leaf.cfg.m for leaf in sgd.tree_leaves(out.get("compute", {}))
              if isinstance(leaf, PregenOp)]
        if m is None:
            if not ms:
                raise ValueError("a residual without pre-generated operands "
                                 "needs m")
            m = ms[0]
        out["err"] = err_from_jax(state["err"], out["master"], m,
                                  device=device)
    return out


def _err_layout(master, m: int):
    """[(reference column, port column, numel)] of every compressible
    leaf (one layer's slice of a stacked leaf), in the reference's order;
    and the padded width.  The port's columns are those of
    ``compress.plan_for(master)``, which compresses what the reference's
    stacked leaves compress (a layer stack of ragged per-layer leaves
    whose stack is whole m-groups as one unit)."""
    plan = C.plan_for(master, m, m)
    paths = []

    def walk(node, path, layer):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), layer)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path, i)
        else:
            paths.append((path, layer, node.numel()))

    walk(master, (), None)
    by_path = {}
    for (path, layer, numel), col in zip(paths, plan.offsets):
        by_path.setdefault(path, []).append((layer, numel, col))
    out, ref = [], 0
    for path in sorted(by_path):          # JAX's flatten order
        entries = by_path[path]
        if entries[0][2] is None:
            continue
        for _, numel, col in entries:     # the stacked leaf's layers in a row
            out.append((ref, col, numel))
            ref += numel
    return out, plan.width


def _move_columns(src: np.ndarray, master, m: int, to_port: bool):
    layout, width = _err_layout(master, m)
    if src.ndim != 2 or src.shape[1] != width:
        raise ValueError(f"EF residual {src.shape} is not (n_pods, {width})")
    out, total = np.zeros_like(src), 0
    for ref, col, numel in layout:
        dst, at = (col, ref) if to_port else (ref, col)
        out[:, dst:dst + numel] = src[:, at:at + numel]
        total += numel
    out[:, total:] = src[:, total:]      # the zero pad
    return out


def err_from_jax(err, master, m: int, *, device=None) -> torch.Tensor:
    """The reference's (n_pods, width) residual in the port's column
    layout for ``master`` (the port's per-layer master tree), bitwise."""
    return tensor_from_numpy(
        _move_columns(np.asarray(err), master, m, to_port=True),
        resolve_device(device))


def err_to_jax(err: torch.Tensor, master, m: int) -> np.ndarray:
    """The inverse of ``err_from_jax``: the reference's slab layout, as a
    numpy array."""
    return _move_columns(err.detach().cpu().numpy(), master, m,
                         to_port=False)
