"""The training loop: step function, data, checkpoints, fault tolerance.

Counterpart of ``src/repro/train/trainer.py``: ``TrainerConfig``,
``train_steps`` (the bare loop) and ``fit`` (with ``CheckpointManager``
saves every ``ckpt_every`` steps, a ``Heartbeat`` and a
``StragglerMonitor``), with the reference's loop rules: bookkeeping is
keyed off the optimizer step ``state["step"]``, a stale data iterator
after a resume is fast-forwarded, and the final save is skipped when the
last periodic save already covered it.

What differs: the step function is a plain callable (``functools.
partial`` of ``train.step.lm_train_step`` or ``image_train_step``, on
either dataflow: a legacy state without a compute tree loops and
checkpoints the same way), not a step bundle; the card is synchronised
by reading the loss.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import Heartbeat, StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    heartbeat_path: Optional[str] = None
    straggler_threshold: float = 2.0


def train_steps(step_fn, state, data_iter: Iterator, n_steps: int):
    """``n_steps`` of ``state, metrics = step_fn(state, batch)`` over
    ``data_iter`` (yielding (step, batch)); returns the final state and
    the per-step metrics, after the card that holds the batch (if one
    does) has finished."""
    history = []
    for _ in range(n_steps):
        _, batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        history.append(metrics)
    for t in batch.values():
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return state, history


def fit(step_fn, state, data_iter: Iterator, tcfg: TrainerConfig,
        log_fn: Callable = print, group=None):
    """Run the loop up to ``tcfg.total_steps``; returns (final_state,
    history of {"step", "loss", "sec", "straggler"}).  Under ``group``
    (one process per pod, the step's own group) every rank runs the
    loop in lockstep, checkpoints go through the group
    (``CheckpointManager(group=)``) and rank 0 alone beats the
    heartbeat."""
    ckpt = (CheckpointManager(tcfg.ckpt_dir, group=group) if tcfg.ckpt_dir
            else None)
    rank = 0
    if group is not None:
        import torch.distributed as dist

        rank = dist.get_rank(group)
    hb = (Heartbeat(tcfg.heartbeat_path)
          if tcfg.heartbeat_path and rank == 0 else None)
    mon = StragglerMonitor(tcfg.straggler_threshold)
    history = []
    cur = int(state["step"])   # authoritative; advances with each update
    last_saved = None          # step of the most recent periodic save
    for it_step, batch in data_iter:
        if it_step < cur:      # stale iterator after a resume
            continue
        if cur >= tcfg.total_steps:
            break
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])   # waits for the step
        dt = time.perf_counter() - t0
        straggler = mon.record(cur, dt)
        rec = {"step": cur, "loss": loss, "sec": dt, "straggler": straggler}
        history.append(rec)
        if hb is not None:
            hb.beat(cur, loss=loss)
        if straggler:
            log_fn(f"[straggler] step {cur}: {dt:.3f}s "
                   f"(mean {mon.mean:.3f}s)")
        if cur % tcfg.log_every == 0:
            log_fn(f"step {cur:5d} loss {loss:.4f} {dt * 1e3:.1f}ms")
        cur += 1
        if ckpt is not None and cur % tcfg.ckpt_every == 0:
            ckpt.save(cur, state)
            last_saved = cur
    if ckpt is not None:
        # the last periodic save covered this step: saving again would
        # race its writer on the same step_XXXX.tmp, so wait for it
        if last_saved == cur:
            ckpt.wait()
        else:
            ckpt.save(cur, state, blocking=True)
    return state, history
