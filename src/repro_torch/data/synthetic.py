"""Deterministic synthetic token stream (numpy, then torch).

The port's own copy of ``TokenTaskConfig``, ``token_batch`` and
``lm_stream`` from ``src/repro/data/synthetic.py`` (that module imports
JAX): Zipfian unigram tokens with a copy-task signal, seeded per
(seed, step), so the same seed gives the reference's batches exactly.

What differs: batches are torch tensors (int64, as torch indexing wants)
on an explicit device, the card unless the caller names another; the
modality prefix and the image/encoder-decoder streams are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab: int
    seq: int
    batch: int
    copy_period: int = 16  # every k-th token repeats (learnable structure)
    zipf_a: float = 1.2
    seed: int = 0


def token_batch(cfg: TokenTaskConfig, step: int):
    """(tokens, labels) int32 numpy arrays; labels are next-token targets."""
    rng = np.random.default_rng(np.random.PCG64([cfg.seed, step]))
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    probs = ranks ** -cfg.zipf_a
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq + 1), p=probs)
    # copy structure: position i repeats position i - copy_period
    for i in range(cfg.copy_period, cfg.seq + 1, cfg.copy_period):
        toks[:, i] = toks[:, i - cfg.copy_period]
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def lm_stream(vocab: int, batch: int, seq: int, *, device=None,
              seed: int = 0, start: int = 0):
    """An iterator of (step, {"tokens", "labels"}) with (batch, seq)
    int64 tensors on ``device`` (the card unless another is named)."""
    device = resolve_device(device)
    cfg = TokenTaskConfig(vocab=vocab, seq=seq, batch=batch, seed=seed)
    return _stream(cfg, device, start)


def _stream(cfg: TokenTaskConfig, device, step: int):
    while True:
        tokens, labels = token_batch(cfg, step)
        yield step, {"tokens": torch.from_numpy(tokens).long().to(device),
                     "labels": torch.from_numpy(labels).long().to(device)}
        step += 1
