"""The bare training loop.

Counterpart of ``src/repro/train/trainer.py:train_steps``.  ``fit``
with checkpoints, heartbeat and straggler monitoring is not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import torch


def train_steps(step_fn, state, data_iter: Iterator, n_steps: int):
    """``n_steps`` of ``state, metrics = step_fn(state, batch)`` over
    ``data_iter`` (yielding (step, batch)); returns the final state and
    the per-step metrics, after the card (if the state is on one) has
    finished."""
    history = []
    for _ in range(n_steps):
        _, batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        history.append(metrics)
    if batch["tokens"].is_cuda:
        torch.cuda.synchronize(batch["tokens"].device)
    return state, history
