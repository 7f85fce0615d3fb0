"""Element-mode packed parameter store — serve from compact (vals, idx).

Counterpart of ``src/repro/serve/packed_params.py``: ``default_idx_bits``,
``pack_tree_element`` and ``PackedParamStore`` with ``report()``.  Each
weight that training FF-prunes and serving may pack becomes
``{"w": PackedOp(vals, idx)}`` (a bias stays dense beside it, as do
the embedding table, a tied head's included, and the norms), SORE-packed along its contraction axis:
vals (K·N/M, F) and idx uint8 (K·N/M, F), or the u4 plane
(ceil(K·N/M / 2), F) — the default whenever M <= 16.  Byte counts equal
the reference's for the same tree.

What differs: the tree is the port's (per-layer block lists, walked
without list indices in the names, so names match the reference's: an
encoder-decoder's ``enc_blocks`` and ``dec_blocks`` both, each stacked
name counted once);
``pack_tree_element`` moves every leaf to ``device`` (the card unless
the caller says otherwise) and packs each weight with one
``kernels.ops.nm_compact`` (the SORE kernel on the card) that reads the
(K, F) weight through its transposed view and writes vals and the index
plane straight into their (Kc, F) layout; ``PackedParamStore.
pack_layerwise`` packs blocks as an iterator yields them, so a
full-width model never holds all of its dense layers at once; a tree of
one rank's blocks (``sharding.tp``) packs by the whole weights'
eligibility (``like=``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import bdwp
from repro_torch.core import operand as O
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_COUNTS = ("n_packed", "n_dense", "packed_bytes", "packed_bytes_4bit",
           "dense_bytes", "other_bytes")


def _leaf_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def default_idx_bits(cfg: SparsityConfig) -> int:
    """4 whenever the in-group offset fits a nibble (M <= 16), else 8."""
    return 4 if cfg.m <= 16 else 8


def pack_tree_element(params, cfg: SparsityConfig,
                      idx_bits: Optional[int] = None, *, pspecs=None,
                      device=None, like=None):
    """Returns ``(packed_tree, stats)``: every eligible ``{"w": (K, F)}``
    leaf-dict becomes ``{"w": PackedOp(vals, idx, cfg, idx_bits)}``, every
    leaf lies on ``device``, and stats counts the actual bytes and, as
    the reference counts a layer-stacked leaf once, each packed or dense
    weight name once however many layers hold it.

    With ``pspecs`` (the params' resolved spec tree) it returns
    ``(packed_tree, stats, packed_pspecs)``: ``vals`` and ``idx`` keep
    w's spec, as the reference's.  A tree on the meta device packs to
    meta shapes, with no kernel run (``launch.spmd.serve_shardings``).
    ``like``, a tree of the same structure holding the whole weights'
    shapes (``transformer_lm.abstract_params``), decides which weights
    pack when ``params`` holds one rank's blocks of them
    (``sharding.tp``): eligibility is the whole weight's."""
    packed, stats, _, out_specs = _pack(params, cfg, idx_bits, device,
                                        pspecs=pspecs, like=like)
    if pspecs is not None:
        return packed, stats, out_specs
    return packed, stats


def _pack(params, cfg, idx_bits, device, names=None, *, pspecs=None,
          like=None):
    """``pack_tree_element`` that also returns the weight names counted
    in ``n_packed``/``n_dense`` (``names``: those counted already, by
    earlier calls on other layers of the same model) and the packed
    spec tree (None without ``pspecs``)."""
    device = resolve_device(device)
    names = {"n_packed": set(), "n_dense": set()} if names is None else names
    if idx_bits is None:
        idx_bits = default_idx_bits(cfg)
    if idx_bits not in (4, 8):
        raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
    stats = dict.fromkeys(_COUNTS, 0)
    stats["idx_bits"] = idx_bits

    def count(key, name):
        if name not in names[key]:
            names[key].add(name)
            stats[key] += 1
    acct_bits = 4 if cfg.m <= 16 else 8

    def pack_ok(name, w) -> bool:
        # a weight that trains dense serves dense: pack only what the
        # masked forward FF-sparsifies and serving may read packed
        lshape = tuple(w.shape[-2:])
        return (cfg.prunes_ff_weights()
                and bdwp.should_prune(name, lshape, cfg)
                and bdwp.serve_packable(name, lshape, cfg))

    def at(tree, k):
        return None if tree is None else tree[k]

    def walk(node, path, spec, whole):
        """(the packed node, its spec): ``spec`` and ``whole`` are the
        node's in ``pspecs`` and ``like`` (None without them)."""
        if isinstance(node, dict) and "w" in node:
            w = node["w"].to(device)
            if not pack_ok("/".join(path), w if whole is None
                           else whole["w"]):
                out = {k: v.to(device) for k, v in node.items()}
                count("n_dense", "/".join(path))
                stats["other_bytes"] += sum(map(_leaf_bytes, out.values()))
                return out, spec
            k, f = w.shape
            kc = k // cfg.m * cfg.n
            vals = torch.empty((kc, f), dtype=w.dtype, device=device)
            idx = torch.empty(((kc + 1) // 2 if idx_bits == 4 else kc, f),
                              dtype=torch.uint8, device=device)
            if not w.is_meta:
                ops.nm_compact(w.t(), cfg.n, cfg.m, idx_bits,
                               out=(vals.t(), idx.t()))
            count("n_packed", "/".join(path))
            stats["dense_bytes"] += _leaf_bytes(w)
            stats["packed_bytes"] += _leaf_bytes(vals) + _leaf_bytes(idx)
            stats["packed_bytes_4bit"] += (
                _leaf_bytes(vals) + vals.numel() * acct_bits // 8)
            out = {"w": O.PackedOp(vals, idx, cfg, idx_bits)}
            out_spec = None if spec is None else {
                "w": O.PackedOp(spec["w"], spec["w"], cfg, idx_bits)}
            if "b" in node:   # a bias is served dense beside the pair
                out["b"] = node["b"].to(device)
                stats["other_bytes"] += _leaf_bytes(out["b"])
                if spec is not None:
                    out_spec["b"] = spec["b"]
            return out, out_spec
        if isinstance(node, dict):
            pairs = {k: walk(v, path + (k,), at(spec, k), at(whole, k))
                     for k, v in node.items()}
            return ({k: p for k, (p, _) in pairs.items()},
                    None if spec is None
                    else {k: s for k, (_, s) in pairs.items()})
        if isinstance(node, list):
            pairs = [walk(v, path, at(spec, i), at(whole, i))
                     for i, v in enumerate(node)]
            return ([p for p, _ in pairs],
                    None if spec is None else [s for _, s in pairs])
        node = node.to(device)
        stats["other_bytes"] += _leaf_bytes(node)
        return node, spec

    packed, out_specs = walk(params, (), pspecs, like)
    return packed, stats, names, out_specs


@dataclasses.dataclass
class PackedParamStore:
    """Packed weights + byte accounting; ``.params`` plugs into forward()."""

    params: dict
    sp_cfg: SparsityConfig
    n_packed: int
    n_dense: int
    idx_bits: int            # stored index width (4 = two offsets/byte)
    packed_bytes: int        # stored bytes of packed leaves (vals + idx)
    packed_bytes_4bit: int   # with ceil(log2 M)-bit indices (SORE format)
    dense_bytes: int         # dense-equivalent bytes of the packed leaves
    other_bytes: int         # leaves served dense (embeds, norms, head)

    @classmethod
    def _from_stats(cls, params, sp_cfg, st) -> "PackedParamStore":
        return cls(params=params, sp_cfg=sp_cfg, idx_bits=st["idx_bits"],
                   **{k: st[k] for k in _COUNTS})

    @classmethod
    def pack(cls, params, sp_cfg: SparsityConfig,
             idx_bits: Optional[int] = None, *, device=None,
             like=None) -> "PackedParamStore":
        """The store of ``pack_tree_element(params, ..., like=like)``."""
        packed, st = pack_tree_element(params, sp_cfg, idx_bits,
                                       device=device, like=like)
        return cls._from_stats(packed, sp_cfg, st)

    @classmethod
    def pack_layerwise(cls, shell, blocks, sp_cfg: SparsityConfig,
                       idx_bits: Optional[int] = None, *,
                       device=None) -> "PackedParamStore":
        """Same store as ``pack({**shell, "blocks": list(blocks)})``, but
        ``blocks`` is consumed one layer at a time: each dense block is
        packed and dropped before the next is drawn.  It knows the LM's
        single ``"blocks"`` list; an encoder-decoder's tree (its
        ``enc_blocks`` and ``dec_blocks``, 3.2 GB of bf16 weights at
        whisper's FULL) goes through ``pack``."""
        params, st, names, _ = _pack(shell, sp_cfg, idx_bits, device)
        params["blocks"] = []
        for block in blocks:
            packed, bst, names, _ = _pack({"blocks": block}, sp_cfg,
                                          idx_bits, device, names)
            params["blocks"].append(packed["blocks"])
            for k in _COUNTS:
                st[k] += bst[k]
            del block, packed
        return cls._from_stats(params, sp_cfg, st)

    @property
    def hbm_saving(self) -> float:
        """Dense/packed byte ratio over the packable weights."""
        return self.dense_bytes / max(self.packed_bytes, 1)

    @property
    def total_bytes(self) -> int:
        return self.packed_bytes + self.other_bytes

    def measured_packed_bytes(self) -> int:
        """Sum of the live buffer sizes of every PackedOp leaf."""
        total = 0

        def walk(node):
            nonlocal total
            if isinstance(node, O.PackedOp):
                total += _leaf_bytes(node.vals) + _leaf_bytes(node.idx)
            elif isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)

        walk(self.params)
        return total

    def report(self) -> dict:
        measured = self.measured_packed_bytes()
        return {
            "n_packed": self.n_packed,
            "n_dense": self.n_dense,
            "n": self.sp_cfg.n, "m": self.sp_cfg.m,
            "idx_bits": self.idx_bits,
            "packed_weight_bytes": self.packed_bytes,
            "packed_weight_bytes_4bit_idx": self.packed_bytes_4bit,
            "measured_packed_weight_bytes": measured,
            "measured_over_accounted_4bit": (
                measured / max(self.packed_bytes_4bit, 1)),
            "dense_weight_bytes": self.dense_bytes,
            "other_param_bytes": self.other_bytes,
            "hbm_saving": self.hbm_saving,
            "total_hbm_bytes": self.total_bytes,
            "total_hbm_bytes_dense": self.dense_bytes + self.other_bytes,
        }
