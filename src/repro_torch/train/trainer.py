"""The training loop: step function, data, checkpoints, fault tolerance.

Counterpart of ``src/repro/train/trainer.py``: ``TrainerConfig``,
``train_steps`` (the bare loop) and ``fit`` (with ``CheckpointManager``
saves every ``ckpt_every`` steps, a ``Heartbeat`` and a
``StragglerMonitor``), with the reference's loop rules: bookkeeping is
keyed off the optimizer step ``state["step"]``, a stale data iterator
after a resume is fast-forwarded, and the final save is skipped when the
last periodic save already covered it.

Both take a ``train.step.StepBundle`` (``build_lm_train`` /
``build_encdec_train``), as the reference's do, or a plain step
callable (``functools.partial`` of ``train.step.lm_train_step`` or
``image_train_step``, on either dataflow: a legacy state without a
compute tree loops and checkpoints the same way).  With a bundle on a
mesh of several ranks every rank runs the loop on its blocks of the
state, checkpoints gather and cut them (``CheckpointManager(
shardings=)``), and rank 0 alone beats the heartbeat.

What differs: the card is synchronised by reading the loss.
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


def _step_of(bundle):
    """The step callable of a ``StepBundle`` or of a bare callable."""
    return getattr(bundle, "step_fn", bundle)


def train_steps(bundle, state, data_iter: Iterator, n_steps: int):
    """``n_steps`` of ``state, metrics = step_fn(state, batch)`` over
    ``data_iter`` (yielding (step, batch)); ``bundle`` is a
    ``StepBundle`` or the step callable itself.  Returns the final state
    and the per-step metrics, after the card that holds the batch (if
    one does) has finished."""
    step_fn = _step_of(bundle)
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


def fit(bundle, state, data_iter: Iterator, tcfg: TrainerConfig,
        log_fn: Callable = print):
    """Run the loop up to ``tcfg.total_steps``; returns (final_state,
    history of {"step", "loss", "sec", "straggler"}).  ``bundle``: a
    ``StepBundle`` (on a mesh: every rank in lockstep on its blocks,
    checkpoints through ``CheckpointManager(shardings=)``, rank 0 alone
    beating the heartbeat) or the step callable."""
    step_fn = _step_of(bundle)
    shardings = getattr(bundle, "state_shardings", None)
    ckpt = (CheckpointManager(tcfg.ckpt_dir, shardings=shardings)
            if tcfg.ckpt_dir else None)
    rank = shardings.mesh.rank if shardings is not None else 0
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
