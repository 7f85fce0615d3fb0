"""Load the JAX reference's parameter and train-state trees into the
port's layout.

No reference counterpart.  ``params_from_jax`` takes the reference's
``transformer_lm.init`` tree, and ``train_state_from_jax`` its train
state, with every array already turned into numpy
(``jax.tree.map(np.asarray, tree)``), so this module needs neither JAX
nor ``repro``:

  * leaves under ``"blocks"`` are stacked along a leading layer axis
    (L, …) and become a list of L per-layer dicts;
  * ``{"w": (K, F)}`` leaf-dicts keep their layout (``x @ w``);
  * a packed operand (the reference's ``PackedOp``, recognised by its
    ``vals``, ``idx``, ``idx_bits`` and ``cfg`` attributes) becomes the
    port's ``PackedOp`` with the same (Kc, F) vals and u8 or u4 idx;
  * bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) are carried bit for
    bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.operand import PackedOp, PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.device import resolve_device


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bfloat16 bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_packed(node) -> bool:
    return all(hasattr(node, a) for a in ("vals", "idx", "idx_bits", "cfg"))


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
    if _is_packed(node):
        vals, idx = np.asarray(node.vals), np.asarray(node.idx)
        if layer is not None:
            vals, idx = vals[layer], idx[layer]
        return PackedOp(tensor_from_numpy(vals, device),
                        tensor_from_numpy(idx, device),
                        _sparsity_config(node.cfg), node.idx_bits)
    a = np.asarray(node)
    return tensor_from_numpy(a if layer is None else a[layer], device)


def _n_layers(node) -> int:
    if isinstance(node, dict):
        return _n_layers(next(iter(node.values())))
    if _is_pregen(node):
        return np.asarray(node.bp).shape[0]
    if _is_packed(node):
        return np.asarray(node.vals).shape[0]
    return np.asarray(node).shape[0]


def params_from_jax(tree, *, device=None):
    """The reference's (stacked) param tree as the port's per-layer tree."""
    device = resolve_device(device)
    out = {k: _convert(v, device, None) for k, v in tree.items()
           if k != "blocks"}
    blocks = tree["blocks"]
    out["blocks"] = [_convert(blocks, device, i)
                     for i in range(_n_layers(blocks))]
    return out


def train_state_from_jax(state, *, device=None):
    """The reference's single-device train state (``master``,
    ``momentum``, ``step`` and the pre-generated ``compute`` tree) as the
    port's per-layer state."""
    device = resolve_device(device)
    out = {k: params_from_jax(state[k], device=device)
           for k in ("master", "momentum", "compute")}
    out["step"] = int(np.asarray(state["step"]))
    return out
