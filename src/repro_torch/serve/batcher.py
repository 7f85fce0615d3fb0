"""Continuous batching over a fixed-capacity slot-paged KV cache.

Counterpart of ``src/repro/serve/batcher.py``: ``SlotKVCache``,
``seat_cache``, ``extract_lane_cache`` and ``ContinuousBatcher``.  The
cache has a leading slot axis (``n_slots`` lanes, ``max_len`` deep);
requests join mid-flight into free slots, and eviction is a host-side
bitmap flip.  Every decode step runs all ``n_slots`` rows at their own
positions, free ones included (their writes are clipped in bounds and
their outputs ignored); prompts are right-padded to ``prompt_bucket``.

What differs: PyTorch runs eagerly, so there is nothing to compile;
the cache is a list of per-layer ``{"k", "v", "pos"}`` dicts of
(n_slots, max_len, Hkv, D) tensors (MLA: ``{"ckv", "kpe", "pos"}``; an
SSM layer's fp32 ``{"state", "conv"}``, a hybrid layer's both),
beside a prelude's cache where the model has one, and seating, decode
writes and lane export work on it in place (the reference donates its
cache to the jitted steps).  With a ``mesh`` of several ranks (one
process a rank, ``ServeEngine(mesh=)``) the cache is allocated at the
rank's block shapes (``sharding.tp.init_cache``) and the steps run with
``mesh=``: over "model" the params are the rank's blocks and the
logits come back whole; over the DP axes ("pod", "data") the rank holds
its DP index' block of the slots, tokens and positions
(``sharding.tp.SlotSplit``; every slot where D does not divide them, as
the reference replicates them).  The host state (the free-slot bitmap,
the queue, the requests) is the same on every rank, which runs the
same loop on the same submissions: every rank prefills each admitted
request (the reference's batch-1 prefill is replicated over DP), only
the slot's owner seats it, a decode step runs the rank's rows and
gathers the token ids whole over the DP group, and a lane's export
comes from its owner to every rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.sparsity import DENSE, SparsityConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer_lm as T
from repro_torch.serve.cache_store import Lane
from repro_torch.sharding import tp
from repro_torch.train import step as ST


# layer-cache entries whose axis 1 is not positions: the SSM's state
# (B, H, N, P) and conv window (B, K-1, C), seated whole
WHOLE_LANE = ("state", "conv")


def seat_cache(cache, pre_cache, slot: int):
    """Write a batch-1 prefill cache into lane ``slot`` of the slot-paged
    cache, in place (the lane's first ``S_pre`` positions of every tensor
    a layer cache holds by position: k/v, or MLA's ckv/kpe; the prelude's
    too; an SSM's state and conv window whole); returns it.  The ``pos``
    cursors stay."""
    pairs = list(zip(cache["layers"], pre_cache["layers"]))
    if "prelude" in cache:
        pairs.append((cache["prelude"], pre_cache["prelude"]))
    for dst, src in pairs:
        for key, t in src.items():
            if not isinstance(t, torch.Tensor):
                continue
            if key in WHOLE_LANE:
                if dst[key].shape[1:] != t.shape[1:]:
                    raise ValueError(f"{key}: lane {tuple(t.shape)} does "
                                     f"not fit {tuple(dst[key].shape)}")
                dst[key][slot:slot + 1] = t
            else:
                dst[key][slot:slot + 1, :t.shape[1]] = t
    return cache


def extract_lane_cache(cache, slot: int, n_slots: int):
    """Copy lane ``slot`` of a slot-paged cache out as a batch-1 cache
    (every block's and the prelude's tensors; the ``pos`` cursors as
    they are); ``seat_cache(cache, extract_lane_cache(cache, s), s)`` is
    exact."""
    if not 0 <= slot < n_slots:
        raise ValueError(f"slot {slot} out of range")

    def lane(lc):
        return {k: t[slot:slot + 1].clone() if isinstance(t, torch.Tensor)
                else t for k, t in lc.items()}

    out = {"layers": [lane(lc) for lc in cache["layers"]]}
    if "prelude" in cache:
        out["prelude"] = lane(cache["prelude"])
    return out


class SlotKVCache:
    """Device cache with a host-side free-slot bitmap."""

    def __init__(self, cfg, n_slots: int, max_len: int, *, device,
                 dtype=torch.bfloat16, mesh=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        if mesh is None:
            self.cache = T.init_lm_cache(cfg, n_slots, max_len,
                                         device=device, dtype=dtype)
        else:   # the rank's slots
            lo, hi = tp.slot_block(n_slots, mesh)
            self.cache = tp.init_cache(cfg, hi - lo, max_len, mesh,
                                       device=device, dtype=dtype)
        self._free = list(range(n_slots))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim the lowest free slot (deterministic reuse order)."""
        if not self._free:
            return None
        self._free.sort()
        return self._free.pop(0)

    def free(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        self._free.append(slot)


class ContinuousBatcher:
    """Prefill/seat/decode over a SlotKVCache.

    Device state: per-slot next input token (n, 1) and per-slot
    absolute write position (n,) of the rank's n slots (all n_slots
    without a DP split), from slot ``lo`` on.
    """

    def __init__(self, params, cfg, sp_cfg: SparsityConfig = DENSE, *,
                 n_slots: int, max_len: int, prompt_bucket: int, device,
                 cache_dtype=torch.bfloat16, mesh=None):
        if prompt_bucket > max_len:
            raise ValueError("prompt_bucket must be <= max_len")
        self.params = params
        self.cfg = cfg
        self.sp_cfg = sp_cfg
        self.prompt_bucket = prompt_bucket
        self.device = device
        self.cache_dtype = cache_dtype
        self.mesh = mesh
        # checked once here; the steps run inside it and do not check
        self.split = tp.serve_split(cfg, mesh)
        self.slots = tp.slot_split(mesh, n_slots)
        self.lo, hi = ((0, n_slots) if self.slots is None
                       else (self.slots.lo, self.slots.hi))
        # the MoE routing groups over every rank's rows
        self.rows = None if mesh is None else tp.rows_split(mesh, n_slots)
        self.kv = SlotKVCache(cfg, n_slots, max_len, device=device,
                              dtype=cache_dtype, mesh=mesh)
        self.tokens = torch.zeros((hi - self.lo, 1), dtype=torch.int64,
                                  device=device)
        self.positions = torch.zeros((hi - self.lo,), dtype=torch.int64,
                                     device=device)
        self.prefill_calls = 0   # prefill runs (a reuse hit skips one)

    # -- admission ----------------------------------------------------------

    def prefill(self, prompt, key=()) -> Lane:
        """Prefill ``prompt`` (len <= prompt_bucket) WITHOUT touching a
        slot; returns the batch-1 Lane that ``seat_lane`` seats."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = prompt.shape[0]
        if not 0 < plen <= self.prompt_bucket:
            raise ValueError(
                f"prompt length {plen} not in (0, {self.prompt_bucket}]")
        padded = np.zeros((1, self.prompt_bucket), np.int64)
        padded[0, :plen] = prompt
        with tp.model_split(self.split):
            logits, pre_cache = ST.lm_prefill_step(
                self.params,
                {"tokens": torch.from_numpy(padded).to(self.device)},
                cfg=self.cfg, sp_cfg=self.sp_cfg, last_index=[plen - 1],
                cache_dtype=self.cache_dtype, mesh=self.mesh)
        first = torch.argmax(logits[:, -1, :self.cfg.vocab], dim=-1)
        self.prefill_calls += 1
        return Lane(key=tuple(key), cache=pre_cache,
                    next_token=int(first[0]), pos=int(plen))

    def _holds(self, slot: int) -> bool:
        return self.slots is None or self.slots.holds(slot)

    def seat_lane(self, lane: Lane) -> int:
        """Seat a batch-1 lane into a free slot (written on the rank that
        holds it); raises if none is free."""
        slot = self.kv.alloc()
        if slot is None:
            raise RuntimeError("no free slot")
        if self._holds(slot):
            row = slot - self.lo
            seat_cache(self.kv.cache, lane.cache, row)
            self.tokens[row, 0] = lane.next_token
            self.positions[row] = lane.pos
        return slot

    def export_lane(self, slot: int, key=()) -> Lane:
        """Copy the live state of lane ``slot`` (cache + next token +
        position) into a batch-1 Lane another engine can seat; over DP
        ranks every rank returns the owner's (``tp.share``)."""
        if not 0 <= slot < self.kv.n_slots:
            raise ValueError(f"slot {slot} out of range")
        row = slot - self.lo if self._holds(slot) else 0   # a buffer of the lane's shapes
        cache1 = extract_lane_cache(self.kv.cache, row,
                                    self.tokens.shape[0])
        head = torch.stack([self.tokens[row, 0], self.positions[row]])
        if not (self.slots is None or self.slots.replicated):
            tp.share(_lane_tensors(cache1) + [head],
                     self.slots.owner(slot), self.slots)
        return Lane(key=tuple(key), cache=cache1,
                    next_token=int(head[0]), pos=int(head[1]))

    def evict(self, slot: int) -> None:
        """Release a slot — host-side only."""
        self.kv.free(slot)

    # -- decode -------------------------------------------------------------

    def step(self) -> np.ndarray:
        """One decode step for all n_slots lanes (the rank's rows, their
        ids then gathered over the DP group); returns (n_slots,)
        next-token ids (garbage on free lanes)."""
        with tp.model_split(self.split), L.token_split(self.rows):
            logits, _ = ST.lm_decode_step(self.params, self.kv.cache,
                                          self.tokens, self.positions,
                                          cfg=self.cfg, sp_cfg=self.sp_cfg,
                                          mesh=self.mesh)
        nxt = torch.argmax(logits[:, -1, :self.cfg.vocab], dim=-1)
        self.tokens = nxt[:, None]
        self.positions = self.positions + 1
        return tp.gather_rows(nxt, self.slots).cpu().numpy()


def _lane_tensors(cache1) -> list:
    """The tensors of a batch-1 lane cache, in a fixed order."""
    groups = cache1["layers"] + ([cache1["prelude"]] if "prelude" in cache1
                                 else [])
    return [t for lc in groups for t in lc.values()
            if isinstance(t, torch.Tensor)]
