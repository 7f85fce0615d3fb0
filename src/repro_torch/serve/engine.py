"""Request lifecycle manager: submit / step / harvest.

Counterpart of ``src/repro/serve/engine.py``: ``ServeConfig``,
``Request`` and ``ServeEngine`` with the same admission order, stop
conditions, prefix lane pool, lane hooks (``prefill_to_lane``,
``submit_lane``, ``export_lane``) and the fleet's router hooks
(``prefix_match_depth``, ``utilization``).  One ``step()`` admits queued
requests into free slots (a prefill each, or a prefix-pool hit), then
runs one decode step for every lane; finished requests free their slot
at once, so a queued request joins on the next step.

``mesh=`` serves over a ``launch.mesh.Mesh`` of several ranks, one
process a rank, as the reference's ``ServeEngine(mesh=)`` does over
devices: the engine resolves ``launch.spmd.serve_shardings``, cuts the
dense tree to the rank's blocks (``sharding.tp.serve_blocks``: the
weights TP over "model", N:M groups whole) and packs those on its
device; the cache holds the rank's block (its KV heads over "model",
its slots over the DP axes "pod" and "data").  Every rank runs the same
host bookkeeping (admission, prefix pool, lanes, stop conditions) on
the same token ids: over "model" every rank reads whole-vocab logits,
over DP the decode step's ids are gathered whole (one gather a step,
``serve.batcher``), so the ranks stay in lockstep.

What differs: the engine runs on an explicit device — the card unless
the caller passes ``device="cpu"`` — and raises when there is none; it
takes either a dense param tree (packed here when ``serve_cfg.packed``)
or a ready ``PackedParamStore`` (with ``mesh=``, the rank's own: its
leaf shapes are checked against the rank's block shapes); any arch of
``repro_torch.configs`` (sliding-window layers take their window in the
per-slot decode's mask); every LM arch serves over the DP axes, and
the dense attention LMs over "model" too (``sharding.tp.check_serve``
refuses the rest at "model" > 1, naming their ROADMAP item 7 line).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.core.sparsity import DENSE, SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.launch import spmd
from repro_torch.models import transformer_lm as T
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.cache_store import CacheStore, Lane, prefix_chain
from repro_torch.serve.packed_params import (PackedParamStore,
                                             pack_tree_element)
from repro_torch.sharding import tp


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static engine shape."""

    n_slots: int = 4          # concurrent requests (KV lanes)
    max_len: int = 96         # per-slot KV depth (prompt + generation)
    prompt_bucket: int = 32   # prompts right-padded to this length
    eos_token: Optional[int] = None  # engine-wide default stop token
    packed: bool = False      # serve from element-packed N:M weights
    idx_bits: Optional[int] = None   # packed index width: 4, 8, or None
    # for u4 whenever M <= 16 (packed_params.default_idx_bits)
    prefix_cache: int = 0     # lanes pooled for prefix/KV reuse (0 = off)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos: Optional[int]
    state: str = "queued"             # queued | running | done
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_step: int = 0
    finish_step: int = 0

    @property
    def finish_reason(self) -> str:
        if self.eos is not None and self.tokens and self.tokens[-1] == self.eos:
            return "eos"
        return "length"


class ServeEngine:
    """Continuous-batching greedy-decode engine over N:M-sparse weights."""

    def __init__(self, params, cfg, sp_cfg: SparsityConfig = DENSE,
                 serve_cfg: Optional[ServeConfig] = None, *, device=None,
                 cache_dtype=torch.bfloat16, mesh=None):
        serve_cfg = serve_cfg if serve_cfg is not None else ServeConfig()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sp_cfg = sp_cfg
        self.serve_cfg = serve_cfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.store: Optional[PackedParamStore] = None
        ready = isinstance(params, PackedParamStore)
        if ready and not serve_cfg.packed:
            raise ValueError("a PackedParamStore needs ServeConfig("
                             "packed=True)")
        pspecs = like = None
        if self.mesh is not None:
            tp.check_serve(cfg, self.mesh)
            tp.split_of(self.mesh)   # raises without a "model" group
            tp.slot_split(self.mesh, serve_cfg.n_slots)   # or a DP one
            pspecs = spmd.serve_shardings(
                cfg, self.mesh, sp_cfg, n_slots=serve_cfg.n_slots,
                max_len=serve_cfg.max_len, packed=serve_cfg.packed,
                idx_bits=params.idx_bits if ready else serve_cfg.idx_bits,
                cache_dtype=cache_dtype)["params"]
            like = T.abstract_params(cfg)
            if ready:
                _check_rank_store(params, like, pspecs, self.mesh)
            else:
                params = tp.serve_blocks(params, pspecs, self.mesh)
        if ready:
            self.store = params
        elif serve_cfg.packed:
            self.store = PackedParamStore.pack(params, sp_cfg,
                                               idx_bits=serve_cfg.idx_bits,
                                               device=self.device, like=like)
        if self.store is not None:
            params = self.store.params
        else:
            params = _to_device(params, self.device)
        self.batcher = ContinuousBatcher(
            params, cfg, sp_cfg,
            n_slots=serve_cfg.n_slots, max_len=serve_cfg.max_len,
            prompt_bucket=serve_cfg.prompt_bucket, device=self.device,
            cache_dtype=cache_dtype, mesh=self.mesh)
        self._queue: deque[Request] = deque()
        self._lane_queue: deque = deque()        # (Request, Lane) handoffs
        self._running: Dict[int, Request] = {}   # slot -> request
        self._done: Dict[int, Request] = {}      # rid -> request
        self._next_rid = 0
        self.step_count = 0
        self.decode_steps = 0
        self.decoded_tokens = 0   # harvested from active lanes only
        self.prefix_pool: Optional[CacheStore] = (
            CacheStore(serve_cfg.prefix_cache)
            if serve_cfg.prefix_cache > 0 else None)

    # -- lifecycle ----------------------------------------------------------

    def validate(self, prompt, max_new_tokens: int) -> List[int]:
        """Check a request against the static engine shape; returns the
        normalized prompt."""
        prompt = [int(t) for t in prompt]
        sc = self.serve_cfg
        if not 0 < len(prompt) <= sc.prompt_bucket:
            raise ValueError(f"prompt length {len(prompt)} not in "
                             f"(0, {sc.prompt_bucket}]")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > sc.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds per-slot KV capacity {sc.max_len}")
        return prompt

    def submit(self, prompt, max_new_tokens: int = 16,
               eos: Optional[int] = None) -> int:
        """Queue a request; returns its rid.  Admission happens in step()."""
        prompt = self.validate(prompt, max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos=eos if eos is not None else self.serve_cfg.eos_token,
                      submit_step=self.step_count)
        self._queue.append(req)
        return rid

    def submit_lane(self, lane: Lane, max_new_tokens: int = 16,
                    eos: Optional[int] = None, *, prompt=(),
                    tokens=None) -> int:
        """Queue an already-prefilled lane; it is seated at the next
        step() with no prefill here.  ``tokens`` (default: the lane's
        next token) were generated upstream and count against
        ``max_new_tokens``."""
        tokens = [int(t) for t in (tokens if tokens is not None
                                   else [lane.next_token])]
        if not tokens:
            raise ValueError("a handed-off lane carries >= 1 token")
        if max_new_tokens < len(tokens):
            raise ValueError(f"lane already holds {len(tokens)} tokens, "
                             f"max_new_tokens={max_new_tokens}")
        if lane.pos + (max_new_tokens - len(tokens)) + 1 > self.serve_cfg.max_len:
            raise ValueError(
                f"lane pos ({lane.pos}) + remaining tokens exceeds "
                f"per-slot KV capacity {self.serve_cfg.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=[int(t) for t in prompt],
                      max_new_tokens=max_new_tokens,
                      eos=eos if eos is not None else self.serve_cfg.eos_token,
                      submit_step=self.step_count, tokens=tokens)
        self._lane_queue.append((req, lane))
        return rid

    def _should_stop(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return req.eos is not None and bool(req.tokens) \
            and req.tokens[-1] == req.eos

    def _finish(self, req: Request) -> None:
        req.state = "done"
        req.finish_step = self.step_count
        self.batcher.evict(req.slot)
        del self._running[req.slot]
        self._done[req.rid] = req

    def _seat(self, req: Request, lane: Lane, events: dict) -> None:
        req.slot = self.batcher.seat_lane(lane)
        req.state = "running"
        self._running[req.slot] = req
        events["admitted"].append(req.rid)

    def step(self) -> dict:
        """Admit from the queues, decode one token for every active slot.

        Returns {"admitted": [rid], "finished": [rid], "active": n}.
        """
        events = {"admitted": [], "finished": [], "active": 0}
        # handed-off lanes paid their prefill upstream: seat them first
        while self._lane_queue and self.batcher.kv.n_free > 0:
            req, lane = self._lane_queue.popleft()
            self._seat(req, lane, events)
            if self._should_stop(req):
                self._finish(req)
                events["finished"].append(req.rid)
        while self._queue and self.batcher.kv.n_free > 0:
            req = self._queue.popleft()
            if self.prefix_pool is not None:
                chain = prefix_chain(req.prompt,
                                     self.serve_cfg.prompt_bucket)
                lane = self.prefix_pool.get(chain)
                if lane is None:
                    lane = self.batcher.prefill(req.prompt, key=chain)
                    self.prefix_pool.put(lane)
            else:
                lane = self.batcher.prefill(req.prompt)
            self._seat(req, lane, events)
            req.tokens.append(lane.next_token)
            self.decoded_tokens += 1
            if self._should_stop(req):   # e.g. max_new_tokens == 1
                self._finish(req)
                events["finished"].append(req.rid)
        if self._running:
            nxt = self.batcher.step()
            self.decode_steps += 1
            for slot, req in list(self._running.items()):
                req.tokens.append(int(nxt[slot]))
                self.decoded_tokens += 1
                if self._should_stop(req):
                    self._finish(req)
                    events["finished"].append(req.rid)
        events["active"] = len(self._running)
        self.step_count += 1
        return events

    def reset(self) -> None:
        """Clear host-side counters/results, keeping the store, the cache
        and the prefix pool; refuses with work in flight."""
        if self._queue or self._lane_queue or self._running:
            raise RuntimeError("reset() with requests queued or running")
        self._done = {}
        self.step_count = 0
        self.decode_steps = 0
        self.decoded_tokens = 0
        self.batcher.prefill_calls = 0

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive step() until queues and slots drain; returns harvest()."""
        steps = 0
        while ((self._queue or self._lane_queue or self._running)
               and steps < max_steps):
            self.step()
            steps += 1
        if self._queue or self._lane_queue or self._running:
            raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return self.harvest()

    def harvest(self) -> Dict[int, List[int]]:
        """Pop finished requests: {rid: generated token ids}."""
        out = {rid: req.tokens for rid, req in self._done.items()}
        self._done = {}
        return out

    # -- fleet hooks --------------------------------------------------------

    def prefill_to_lane(self, prompt, max_new_tokens: int = 16) -> Lane:
        """Prefill (or hit the prefix pool) and return the seatable Lane
        without occupying a slot of this engine."""
        prompt = self.validate(prompt, max_new_tokens)
        chain = prefix_chain(prompt, self.serve_cfg.prompt_bucket)
        if self.prefix_pool is not None:
            lane = self.prefix_pool.get(chain)
            if lane is not None:
                return lane
        lane = self.batcher.prefill(prompt, key=chain)
        if self.prefix_pool is not None:
            self.prefix_pool.put(lane)
        return lane

    def export_lane(self, rid: int) -> Lane:
        """Freeze a running request's KV lane into a batch-1 Lane and
        release its slot; the request is detached from this engine."""
        req = next((r for r in self._running.values() if r.rid == rid),
                   None)
        if req is None:
            raise KeyError(f"rid {rid} is not running on this engine")
        lane = self.batcher.export_lane(req.slot)
        self.batcher.evict(req.slot)
        del self._running[req.slot]
        req.slot, req.state = None, "exported"
        return lane

    def prefix_match_depth(self, chain) -> int:
        """How many leading prompt blocks of ``chain`` this engine's
        prefix pool already holds: the router's KV-affinity signal."""
        return (self.prefix_pool.match_depth(chain)
                if self.prefix_pool is not None else 0)

    def utilization(self) -> dict:
        """Live occupancy snapshot the fleet routes on."""
        n = self.serve_cfg.n_slots
        queued = self.n_queued
        return {"n_slots": n, "running": self.n_running,
                "queued": queued, "free_slots": self.batcher.kv.n_free,
                "load": (self.n_running + queued) / n}

    # -- introspection ------------------------------------------------------

    @property
    def n_queued(self) -> int:
        return len(self._queue) + len(self._lane_queue)

    @property
    def n_running(self) -> int:
        return len(self._running)

    @property
    def prefill_steps(self) -> int:
        return self.batcher.prefill_calls

    def hbm_report(self) -> Optional[dict]:
        """Packed-weight device bytes (None when serving dense)."""
        return self.store.report() if self.store is not None else None

    def stats(self) -> dict:
        out = {
            "steps": self.step_count,
            "decode_steps": self.decode_steps,
            "decoded_tokens": self.decoded_tokens,
            "prefill_steps": self.prefill_steps,
            "n_slots": self.serve_cfg.n_slots,
            "queued": self.n_queued,
            "running": self.n_running,
        }
        if self.prefix_pool is not None:
            out["prefix_pool"] = self.prefix_pool.stats()
        return out


def _check_rank_store(store, like, pspecs, mesh) -> None:
    """Raise unless ``store`` holds this rank's blocks: its leaf shapes
    those of the rank's blocks of the whole packed tree."""
    whole = pack_tree_element(like, store.sp_cfg, store.idx_bits,
                              device="meta")[0]
    want = tp.leaf_shapes(tp.serve_blocks(whole, pspecs, mesh))
    got = tp.leaf_shapes(store.params)
    if got != want:
        k = next(k for k in sorted(set(got) | set(want), key=str)
                 if got.get(k) != want.get(k))
        raise ValueError(
            f"the PackedParamStore is not this rank's ("
            f"{dict(mesh.coords)} of {dict(mesh.shape)}): leaf "
            f"{'/'.join(map(str, k))} is {got.get(k)}, its block is "
            f"{want.get(k)}")


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    return node.to(device)
