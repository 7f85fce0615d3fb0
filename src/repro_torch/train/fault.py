"""Straggler detection, liveness and the restart path of the training loop.

The port's own copy of ``src/repro/train/fault.py`` (which imports no
JAX but belongs to the reference package): ``StragglerMonitor`` (an
EWMA of step times that flags a step slower than ``threshold`` times the
mean, after ``warmup`` discarded samples), ``Heartbeat`` (an atomically
replaced JSON liveness file, one scratch name per writer) and
``recover_or_init`` (the newest checkpoint, or a fresh init).

What differs: ``recover_or_init`` restores onto a device (the card
unless the caller names another) instead of under a mesh's shardings.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ewma: float = 0.9,
                 warmup: int = 3):
        self.threshold = threshold
        self.alpha = ewma
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.count = 0
        self.flagged = []

    def record(self, step: int, seconds: float) -> bool:
        """True if this step is a straggler.  The first ``warmup``
        samples (the first step builds the kernels and warms the
        allocator) neither seed nor move the mean; stragglers do not
        move it either."""
        self.count += 1
        if self.count <= self.warmup:
            return False
        if self.mean is None:
            self.mean = seconds
            return False
        is_straggler = seconds > self.threshold * self.mean
        if is_straggler:
            self.flagged.append((step, seconds, self.mean))
        else:
            self.mean = self.alpha * self.mean + (1 - self.alpha) * seconds
        return is_straggler


class Heartbeat:
    def __init__(self, path: str):
        self.path = path
        # a scratch name per writer: an old and a new process may overlap
        # during a restart, and os.replace onto ``path`` stays the one
        # atomic commit point
        self._tmp = f"{path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"

    def beat(self, step: int, **info):
        payload = {"step": step, "time": time.time(), **info}
        with open(self._tmp, "w") as f:
            json.dump(payload, f)
        os.replace(self._tmp, self.path)

    def age(self) -> Optional[float]:
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["time"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return None

    def is_stale(self, timeout: float) -> bool:
        age = self.age()
        return age is None or age > timeout


def recover_or_init(ckpt_mgr, init_fn, like_state=None, device=None,
                    restore_fn=None):
    """(state, step): the newest checkpoint restored into the structure
    of ``like_state`` (or of ``init_fn()``) on ``device``, or
    ``init_fn()`` and 0 when there is none.  ``restore_fn`` overrides
    ``ckpt_mgr.restore`` with the same signature."""
    step = ckpt_mgr.latest_step()
    if step is None:
        return init_fn(), 0
    like = like_state if like_state is not None else init_fn()
    restore = restore_fn if restore_fn is not None else ckpt_mgr.restore
    return restore(like, step=step, device=device), step
