"""Serve fleet: one frontend, N engine replicas, KV-aware routing.

Counterpart of ``src/repro/serve/fleet.py``: ``ROUTERS``,
``FleetConfig``, ``FleetRequest``, ``Router``, ``ServeFleet`` and
``AsyncFrontend`` with the same admission queue, routing decisions,
prefill/decode disaggregation and statistics.  A single admission queue
sits in front of N continuous-batching replicas and routes each request
where its KV prefix already is: compute saved by N:M sparsity becomes
wall-clock saved only when the scheduler places work where the state
is (arXiv 2309.13015, dataflow), and here the state is KV.

Routing policy (``FleetConfig.router``):

  * ``"prefix"`` (default): prefer the replica whose prefix pool holds
    the longest match of the prompt's block-hash chain
    (``cache_store.prefix_chain`` at ``prompt_bucket`` granularity), so
    its admission seats the pooled lane and skips the prefill; ties and
    depth 0 go to the least loaded; a holder whose backlog passes the
    least loaded one's by a slot count plus ``balance_slack`` is
    overruled by load;
  * ``"least_loaded"``: live utilization alone;
  * ``"random"``: seeded uniform picks (``numpy.random.default_rng``,
    the reference's host-side draw, so the picks are the reference's
    for the same seed); the control arm.

Disaggregated mode (``FleetConfig.disaggregate=True``): prefill engines
run the prefills (and the prefix pools) and publish each finished lane
into a ``CacheStore`` under the request's id; the frontend routes the
lanes to the least loaded decode replica, which seats it
(``submit_lane``) and decodes.  The handoff leaves the token stream as
a single engine's.

``AsyncFrontend`` wraps the fleet for asyncio: concurrent
``generate()`` coroutines share the queue and one driver task steps the
fleet until their futures resolve.

What differs from the reference:

  * ``devices=`` takes the place of ``meshes=``: one torch device per
    decode replica (``launch.spmd.fleet_meshes`` gives them), or
    ``None`` for every replica on ``device``, the card unless the
    caller passes ``device="cpu"``.  Prefill engines run on ``device``,
    as the reference builds them without a mesh.  On one card the
    replicas share it.
  * ``params`` is a dense tree or a ready ``PackedParamStore``.  With
    ``ServeConfig(packed=True)`` a dense tree is packed once per device
    and a store is used as it is, so replicas on one device share one
    copy of the packed weights; a store on another device than a
    replica's raises ``ValueError``.
  * A lane handed to a decode replica on another device than its
    prefill engine's crosses to the replica's device as it is seated:
    ``batcher.seat_cache`` copies it into the replica's slot-paged
    cache.
"""

from __future__ import annotations

import asyncio
import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.sparsity import DENSE, SparsityConfig
from repro_torch.device import resolve_device
from repro_torch.serve.cache_store import CacheStore, prefix_chain
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.packed_params import PackedParamStore

ROUTERS = ("prefix", "least_loaded", "random")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_replicas: int = 2       # decode-capable engine replicas
    router: str = "prefix"    # "prefix" | "least_loaded" | "random"
    route_seed: int = 0       # rng seed for the "random" control arm
    prefix_cache: int = 8     # per-engine lane pool capacity (0 = off;
    #                           "prefix" routing needs it > 0)
    balance_slack: int = 0    # extra backlog (beyond the least-loaded
    # replica's, in requests) a prefix holder may carry before load
    # overrules affinity; 0 = overrule as soon as the holder is busier
    # by a full slot-count than the emptiest replica
    disaggregate: bool = False
    n_prefill: int = 1        # dedicated prefill engines (disagg mode)

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.router not in ROUTERS:
            raise ValueError(f"router {self.router!r} not in {ROUTERS}")
        if self.disaggregate and self.n_prefill < 1:
            raise ValueError("disaggregate mode needs n_prefill >= 1")


@dataclasses.dataclass
class FleetRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos: Optional[int]
    state: str = "queued"          # queued | prefilling | running | done
    replica: Optional[int] = None  # decode engine index
    engine_rid: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_step: int = 0
    finish_step: int = 0
    prefix_hit: bool = False       # admission reused a pooled lane


class Router:
    """Pick a replica for (chain, live utilization) under one policy."""

    def __init__(self, policy: str, seed: int = 0, balance_slack: int = 0):
        if policy not in ROUTERS:
            raise ValueError(f"router {policy!r} not in {ROUTERS}")
        self.policy = policy
        self.balance_slack = balance_slack
        self._rng = np.random.default_rng(seed)
        self.by_depth: Dict[int, int] = {}   # match depth -> decisions

    def choose(self, engines, chain) -> int:
        loads = [e.utilization() for e in engines]
        # backlog in requests (running + queued): comparable across
        # replicas of equal slot count
        backlog = [u["running"] + u["queued"] for u in loads]
        if self.policy == "random":
            pick = int(self._rng.integers(len(engines)))
            self.by_depth[0] = self.by_depth.get(0, 0) + 1
            return pick
        least = min(range(len(engines)), key=lambda i: (backlog[i], i))
        if self.policy == "least_loaded":
            self.by_depth[0] = self.by_depth.get(0, 0) + 1
            return least
        depths = [e.prefix_match_depth(chain) for e in engines]
        best = max(depths)
        pick = least
        if best > 0:
            # deepest match, least-loaded among equals
            pick = min((i for i in range(len(engines))
                        if depths[i] == best),
                       key=lambda i: (backlog[i], i))
            # affinity yields to load once the holder's backlog exceeds
            # the emptiest replica's by a slot-count (+ slack): a hit
            # saves one prefill, not a queue's worth of decode steps
            limit = (backlog[least] + loads[pick]["n_slots"]
                     + self.balance_slack)
            if backlog[pick] > limit:
                pick, best = least, 0
        self.by_depth[best] = self.by_depth.get(best, 0) + 1
        return pick


class ServeFleet:
    """Single-queue frontend over N continuous-batching replicas."""

    def __init__(self, params, cfg, sp_cfg: SparsityConfig = DENSE,
                 serve_cfg: Optional[ServeConfig] = None,
                 fleet_cfg: Optional[FleetConfig] = None, *,
                 devices=None, device=None, cache_dtype=torch.bfloat16):
        serve_cfg = serve_cfg if serve_cfg is not None else ServeConfig()
        fleet_cfg = fleet_cfg if fleet_cfg is not None else FleetConfig()
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.fleet_cfg = fleet_cfg
        scfg = dataclasses.replace(serve_cfg,
                                   prefix_cache=fleet_cfg.prefix_cache)
        if devices is not None and len(devices) != fleet_cfg.n_replicas:
            raise ValueError(f"{len(devices)} devices for "
                             f"{fleet_cfg.n_replicas} replicas")
        replica_devices = ([_device(d) for d in devices]
                           if devices is not None
                           else [_device(device)] * fleet_cfg.n_replicas)
        prefill_devices = ([_device(device)] * fleet_cfg.n_prefill
                           if fleet_cfg.disaggregate else [])
        weights = _weights_per_device(params, sp_cfg, serve_cfg,
                                      replica_devices + prefill_devices)

        # decode-capable replicas.  In disaggregated mode their prefix
        # pools are idle (lanes arrive seated); the pools live on the
        # prefill engines instead, so pass prefix_cache=0 to the
        # decode side to keep its admission path prefill-free.
        decode_cfg = (dataclasses.replace(scfg, prefix_cache=0)
                      if fleet_cfg.disaggregate else scfg)
        self.engines = [ServeEngine(weights[d], cfg, sp_cfg, decode_cfg,
                                    device=d, cache_dtype=cache_dtype)
                        for d in replica_devices]
        self.prefill_engines = [ServeEngine(weights[d], cfg, sp_cfg, scfg,
                                            device=d,
                                            cache_dtype=cache_dtype)
                                for d in prefill_devices]
        self.router = Router(fleet_cfg.router, fleet_cfg.route_seed,
                             fleet_cfg.balance_slack)
        # prefill engines are routed by prefix affinity too; decode
        # placement of a handed-off lane is pure load balancing
        self.prefill_router = Router(fleet_cfg.router, fleet_cfg.route_seed,
                                     fleet_cfg.balance_slack)
        self.store = CacheStore(capacity=max(
            8, fleet_cfg.n_replicas * serve_cfg.n_slots * 2))
        self._queue: deque[FleetRequest] = deque()
        self._handoff: deque[FleetRequest] = deque()  # lanes in the store
        self._inflight: Dict[tuple, FleetRequest] = {}  # (replica, erid)
        self._done: Dict[int, FleetRequest] = {}
        self._next_rid = 0
        self.step_count = 0

    # -- lifecycle ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               eos: Optional[int] = None) -> int:
        """Queue a request on the fleet-wide admission queue."""
        probe = (self.prefill_engines or self.engines)[0]
        prompt = probe.validate(prompt, max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        req = FleetRequest(rid=rid, prompt=prompt,
                           max_new_tokens=max_new_tokens,
                           eos=(eos if eos is not None
                                else self.serve_cfg.eos_token),
                           submit_step=self.step_count)
        self._queue.append(req)
        return rid

    def _finish(self, req: FleetRequest, tokens: List[int]) -> None:
        req.tokens = list(tokens)
        req.state = "done"
        req.finish_step = self.step_count
        self._done[req.rid] = req

    @staticmethod
    def _has_room(engines: List[ServeEngine]) -> bool:
        """Some replica could seat new work within a step or two.  The
        frontend holds the rest of the queue back: routing a request the
        moment a slot frees lets the decision see every prefix pool and
        utilization update from the steps in between; dispatching the
        whole queue up front would route against stale (empty) state."""
        return any(e.n_running + e.n_queued < e.serve_cfg.n_slots
                   for e in engines)

    def _dispatch_colocated(self) -> None:
        while self._queue and self._has_room(self.engines):
            req = self._queue.popleft()
            chain = prefix_chain(req.prompt, self.serve_cfg.prompt_bucket)
            i = self.router.choose(self.engines, chain)
            eng = self.engines[i]
            req.prefix_hit = eng.prefix_match_depth(chain) >= len(chain)
            req.replica = i
            req.engine_rid = eng.submit(req.prompt, req.max_new_tokens,
                                        eos=req.eos)
            req.state = "running"
            self._inflight[(i, req.engine_rid)] = req

    def _dispatch_disaggregated(self) -> None:
        # phase 1: prefill.  Each prefill engine runs at most n_slots
        # prefills per fleet step (its own admission-loop width), then
        # publishes the lane into the CacheStore
        budget = {j: self.prefill_engines[j].serve_cfg.n_slots
                  for j in range(len(self.prefill_engines))}
        # never outrun the handoff store: an LRU-evicted handoff lane
        # would be lost, so prefill stalls at store capacity instead
        while (self._queue and any(budget.values())
               and len(self.store) < self.store.capacity):
            req = self._queue.popleft()
            chain = prefix_chain(req.prompt, self.serve_cfg.prompt_bucket)
            j = self.prefill_router.choose(
                [self.prefill_engines[k] for k in budget if budget[k]],
                chain)
            j = [k for k in budget if budget[k]][j]
            peng = self.prefill_engines[j]
            req.prefix_hit = peng.prefix_match_depth(chain) >= len(chain)
            budget[j] -= 1
            lane = peng.prefill_to_lane(req.prompt, req.max_new_tokens)
            first = lane.next_token
            req.tokens = [first]
            if (req.max_new_tokens == 1
                    or (req.eos is not None and first == req.eos)):
                self._finish(req, req.tokens)   # never reaches decode
                continue
            # republish under the request id: the handoff key must be
            # unique per request even when prompts (and chains) repeat
            lane = dataclasses.replace(lane, key=("rid", req.rid))
            self.store.put(lane)
            req.state = "prefilling"
            self._handoff.append(req)
        # phase 2: route finished lanes to decode engines (pure load).
        # With every decode replica saturated the lanes stay parked in
        # the store and prefill keeps running ahead: that buffering is
        # the point of disaggregating the two phases
        while self._handoff and self._has_room(self.engines):
            req = self._handoff.popleft()
            lane = self.store.pop(("rid", req.rid))
            if lane is None:
                raise RuntimeError(f"lane for rid {req.rid} lost from "
                                   f"the cache store")
            i = self.router.choose(self.engines, ())
            eng = self.engines[i]
            req.replica = i
            req.engine_rid = eng.submit_lane(
                lane, req.max_new_tokens, eos=req.eos,
                prompt=req.prompt, tokens=req.tokens)
            req.state = "running"
            self._inflight[(i, req.engine_rid)] = req

    def step(self) -> dict:
        """Route everything queued, then step every decode replica once.

        Returns {"dispatched": n, "finished": [fleet rids], "active": n}.
        """
        events = {"dispatched": 0, "finished": [], "active": 0}
        n_q = len(self._queue)
        if self.fleet_cfg.disaggregate:
            self._dispatch_disaggregated()
        else:
            self._dispatch_colocated()
        events["dispatched"] = n_q - len(self._queue)
        for i, eng in enumerate(self.engines):
            if eng.n_running or eng.n_queued:
                eng.step()
            for erid, toks in eng.harvest().items():
                req = self._inflight.pop((i, erid))
                self._finish(req, toks)
                events["finished"].append(req.rid)
        events["active"] = sum(e.n_running + e.n_queued
                               for e in self.engines) + len(self._queue)
        self.step_count += 1
        return events

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive step() until every submitted request finished."""
        steps = 0
        while (self._queue or self._handoff or self._inflight) \
                and steps < max_steps:
            self.step()
            steps += 1
        if self._queue or self._handoff or self._inflight:
            raise RuntimeError(f"fleet did not drain in {max_steps} steps")
        return self.harvest()

    @property
    def finished_requests(self) -> List[FleetRequest]:
        return list(self._done.values())

    def harvest(self) -> Dict[int, List[int]]:
        out = {rid: req.tokens for rid, req in self._done.items()}
        self._done = {}
        return out

    # -- introspection ------------------------------------------------------

    @property
    def n_pending(self) -> int:
        return len(self._queue) + len(self._handoff) + len(self._inflight)

    def stats(self) -> dict:
        return {
            "steps": self.step_count,
            "router": self.fleet_cfg.router,
            "routed_by_depth": dict(self.router.by_depth),
            "prefill_steps": sum(
                e.prefill_steps
                for e in self.engines + self.prefill_engines),
            "decode_steps": sum(e.decode_steps for e in self.engines),
            "engines": [e.stats() for e in self.engines],
            "prefill_engines": [e.stats() for e in self.prefill_engines],
            "store": self.store.stats(),
        }


class AsyncFrontend:
    """Asyncio face of the fleet: concurrent ``generate()`` coroutines
    feed the shared queue; one lazily started driver task steps the
    fleet while anything is pending and resolves per-request futures."""

    def __init__(self, fleet: ServeFleet):
        self.fleet = fleet
        self._pending: Dict[int, asyncio.Future] = {}
        self._driver: Optional[asyncio.Task] = None

    async def generate(self, prompt, max_new_tokens: int = 16,
                       eos: Optional[int] = None) -> List[int]:
        rid = self.fleet.submit(prompt, max_new_tokens, eos=eos)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        if self._driver is None or self._driver.done():
            self._driver = asyncio.get_running_loop().create_task(
                self._drive())
        return await fut

    async def _drive(self) -> None:
        while self._pending:
            self.fleet.step()
            for rid, toks in self.fleet.harvest().items():
                fut = self._pending.pop(rid, None)
                if fut is not None and not fut.done():
                    fut.set_result(toks)
            # yield so freshly submitted generate() calls join the queue
            # between fleet steps
            await asyncio.sleep(0)


def _weights_per_device(params, sp_cfg, serve_cfg, devices) -> dict:
    """{device: what its engines take}: with ``serve_cfg.packed`` one
    ``PackedParamStore`` per distinct device (a given store on its own
    device only), else the dense tree for each engine to place."""
    out = {}
    for d in devices:
        if d in out:
            continue
        if isinstance(params, PackedParamStore):
            on = _tree_device(params.params)
            if on != d:
                raise ValueError(f"the PackedParamStore lies on {on}, a "
                                 f"replica on {d}")
            out[d] = params
        elif serve_cfg.packed:
            out[d] = PackedParamStore.pack(params, sp_cfg,
                                           idx_bits=serve_cfg.idx_bits,
                                           device=d)
        else:
            out[d] = params
    return out


def _device(device) -> torch.device:
    """``resolve_device`` with a CUDA index always named, so that one
    card compares equal however the caller wrote it."""
    d = resolve_device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _tree_device(node) -> Optional[torch.device]:
    """The device of the first plain tensor in a param tree (the
    embedding table's, before any packed operand)."""
    if isinstance(node, torch.Tensor):
        return node.device
    children = (node.values() if isinstance(node, dict)
                else node if isinstance(node, list) else ())
    for child in children:
        d = _tree_device(child)
        if d is not None:
            return d
    return None

