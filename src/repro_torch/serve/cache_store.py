"""CacheStore: host-side pool of batch-1 KV lanes keyed by prefix hash.

The port's own copy of ``src/repro/serve/cache_store.py`` (which imports
no JAX): ``prefix_chain``, ``match_depth``, ``Lane`` and ``CacheStore``
are unchanged; a lane's cache is the port's batch-1 cache dict.

A *lane* is everything the continuous batcher needs to seat a request
into a free slot without running prefill again: the batch-1 cache
pytree a prefill produced (or a slot-slice exported from a live
engine), the next input token, and the absolute decode position.  Two
consumers ride the same abstraction:

  * **prefix reuse** — an engine pools the prefill lane of every prompt
    it serves, keyed by the prompt's block-hash chain; a later request
    with the same chain seats the pooled lane instead of prefilling
    (the KvCacheManager pattern: the router asks each replica for its
    ``match_depth`` and prefers the replica already holding the longest
    matching prefix);
  * **prefill/decode disaggregation** — a dedicated prefill engine
    publishes finished lanes here and a decode engine pops them at
    admission time (the handoff buffer between the two engine pools).

Hashing granularity: prompts are chunked at the engine's
``prompt_bucket`` (the prefill compiles one bucket, so a bucket is the
unit of KV a replica can actually reuse).  ``prefix_chain`` emits one
cumulative digest per chunk; today's engine validates prompts to a
single bucket so chains have length 1, but the chain/match-depth
machinery is written for multi-bucket prompts.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Optional, Tuple


def prefix_chain(prompt, block: int) -> Tuple[str, ...]:
    """Cumulative block-hash chain of ``prompt`` at ``block`` tokens per
    chunk.  chain[k] digests tokens[0 : (k+1)*block] (the last chunk may
    be partial — its digest covers its true length, so two prompts get
    equal chains iff the token sequences are identical)."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    toks = [int(t) for t in prompt]
    chain = []
    h = hashlib.blake2b(digest_size=16)
    for start in range(0, len(toks), block):
        chunk = toks[start:start + block]
        h.update(len(chunk).to_bytes(4, "little"))
        for t in chunk:
            h.update(int(t).to_bytes(8, "little", signed=True))
        chain.append(h.hexdigest())
    return tuple(chain)


def match_depth(stored: Tuple[str, ...], query: Tuple[str, ...]) -> int:
    """Length of the common leading-block prefix of two chains."""
    d = 0
    for a, b in zip(stored, query):
        if a != b:
            break
        d += 1
    return d


@dataclasses.dataclass
class Lane:
    """One seatable KV lane (batch-1)."""

    key: Tuple[str, ...]       # prefix chain (reuse) or handoff key
    cache: Any                 # batch-1 cache pytree (bucket- or max_len-deep)
    next_token: int            # next decode input for this lane
    pos: int                   # absolute write position (== prompt len
    #                            right after prefill)


class CacheStore:
    """Bounded LRU of lanes with prefix-chain lookup + hit accounting."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lanes: "OrderedDict[Tuple[str, ...], Lane]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._lanes)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._lanes

    def put(self, lane: Lane) -> None:
        key = tuple(lane.key)
        if key not in self._lanes and len(self._lanes) >= self.capacity:
            self._lanes.popitem(last=False)
            self.evictions += 1
        self._lanes[key] = lane
        self._lanes.move_to_end(key)
        self.puts += 1

    def get(self, key) -> Optional[Lane]:
        """Exact-chain lookup; hit refreshes LRU recency, lane stays."""
        lane = self._lanes.get(tuple(key))
        if lane is None:
            self.misses += 1
            return None
        self._lanes.move_to_end(tuple(lane.key))
        self.hits += 1
        return lane

    def pop(self, key) -> Optional[Lane]:
        """Remove-and-return (the disaggregation handoff: a lane is
        consumed by exactly one decode engine)."""
        return self._lanes.pop(tuple(key), None)

    def match_depth(self, chain) -> int:
        """Longest common leading-block prefix between ``chain`` and any
        stored lane's key — the router's KV-affinity signal."""
        chain = tuple(chain)
        best = 0
        for key in self._lanes:
            best = max(best, match_depth(key, chain))
        return best

    def stats(self) -> dict:
        return {"size": len(self._lanes), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "puts": self.puts, "evictions": self.evictions}
