"""Deterministic synthetic token and image streams (numpy, then torch).

The port's own copy of ``TokenTaskConfig``, ``token_batch``,
``lm_stream``, ``encdec_stream``, ``ImageTaskConfig`` and
``image_batch`` from
``src/repro/data/synthetic.py`` (that module imports JAX): Zipfian
unigram tokens with a copy-task signal, and class-conditional image
blobs, seeded per (seed, step), so the same seed gives the reference's
batches exactly.

``rows=(index, count)`` gives one rank of a mesh its part of the
global batch: every rank draws the same global batch from the seed and
keeps the contiguous block ``index`` of ``count`` of its rows, the
block the reference's ``P(("pod", "data"), None)`` puts on the device
at (pod, data) = divmod(index, data size).

What differs: batches are torch tensors (tokens and labels int64, as
torch indexing wants; images fp32 NHWC) on an explicit device, the card
unless the caller names another; the class prototypes are drawn once
per task and cached (the same bits); ``image_stream`` is the image
counterpart of ``lm_stream`` (the reference's image callers loop over
``image_batch`` themselves).
"""

from __future__ import annotations

import dataclasses
import functools

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


def row_block(batch: int, rows) -> slice:
    """The rows of block ``index`` of ``count`` (``rows``) of a global
    batch; all rows for None."""
    if rows is None:
        return slice(None)
    index, count = rows
    if batch % count:
        raise ValueError(f"global batch {batch} does not split into "
                         f"{count} row blocks")
    per = batch // count
    return slice(index * per, (index + 1) * per)


def _take(batch: dict, rows, n: int) -> dict:
    sl = row_block(n, rows)
    return {k: v[sl] for k, v in batch.items()}


def lm_stream(vocab: int, batch: int, seq: int, *, device=None,
              seed: int = 0, start: int = 0, prefix: int = 0,
              d_model: int = 0, rows=None):
    """An iterator of (step, {"tokens", "labels"}) with (batch, seq)
    int64 tensors on ``device`` (the card unless another is named).
    ``prefix`` > 0 adds "prefix_embeds", (batch, prefix, d_model) bf16
    stub-frontend embeddings: normals from ``PCG64([seed + 7, step])``
    rounded to bf16, the reference's bits.  ``rows=(index, count)``:
    only that row block of each batch."""
    device = resolve_device(device)
    cfg = TokenTaskConfig(vocab=vocab, seq=seq, batch=batch, seed=seed)
    return _rows(_stream(cfg, device, start, prefix, d_model), rows, batch)


def _rows(stream, rows, batch: int):
    for step, b in stream:
        yield step, (b if rows is None else _take(b, rows, batch))


def _stream(cfg: TokenTaskConfig, device, step: int, prefix: int,
            d_model: int):
    while True:
        tokens, labels = token_batch(cfg, step)
        out = {"tokens": torch.from_numpy(tokens).long().to(device),
               "labels": torch.from_numpy(labels).long().to(device)}
        if prefix:
            rng = np.random.default_rng(np.random.PCG64([cfg.seed + 7,
                                                         step]))
            emb = rng.normal(size=(cfg.batch, prefix, d_model))
            out["prefix_embeds"] = torch.from_numpy(
                emb.astype(np.float32)).to(torch.bfloat16).to(device)
        yield step, out
        step += 1


def encdec_stream(vocab: int, batch: int, seq: int, d_model: int, *,
                  enc_frames: int = 128, device=None, seed: int = 0,
                  start: int = 0, rows=None):
    """The Whisper-style stream: an iterator of (step, {"frames",
    "tokens", "labels"}) on ``device`` (the card unless another is
    named).  "frames" are (batch, enc_frames, d_model) bf16 stub frame
    embeddings, normals from ``PCG64([seed + 11, step])`` rounded to bf16
    (the reference's bits); "tokens" and "labels" (batch, seq) int64 from
    ``token_batch``.  ``rows=(index, count)``: only that row block of
    each batch."""
    device = resolve_device(device)
    cfg = TokenTaskConfig(vocab=vocab, seq=seq, batch=batch, seed=seed)
    return _rows(_encdec_stream(cfg, device, start, enc_frames, d_model),
                 rows, batch)


def _encdec_stream(cfg: TokenTaskConfig, device, step: int, enc_frames: int,
                   d_model: int):
    while True:
        tokens, labels = token_batch(cfg, step)
        rng = np.random.default_rng(np.random.PCG64([cfg.seed + 11, step]))
        frames = rng.normal(size=(cfg.batch, enc_frames, d_model))
        yield step, {
            "frames": torch.from_numpy(frames.astype(np.float32)).to(
                torch.bfloat16).to(device),
            "tokens": torch.from_numpy(tokens).long().to(device),
            "labels": torch.from_numpy(labels).long().to(device)}
        step += 1


@dataclasses.dataclass(frozen=True)
class ImageTaskConfig:
    image: int = 32
    num_classes: int = 10
    batch: int = 128
    noise: float = 0.6
    seed: int = 0


@functools.lru_cache(maxsize=4)
def _prototypes(seed: int, num_classes: int, image: int) -> np.ndarray:
    """The class prototypes of a task, drawn once per (seed, classes,
    image size): at ImageNet's shapes a draw is 1000 x 224 x 224 x 3
    float64 normals (1.2 GB), which the reference draws anew for every
    batch.  Read-only, so a cached array cannot be changed."""
    proto_rng = np.random.default_rng(np.random.PCG64([seed + 2]))
    protos = proto_rng.normal(size=(num_classes, image, image, 3))
    protos.flags.writeable = False
    return protos


def _image_arrays(cfg: ImageTaskConfig, step: int):
    """The reference's ``image_batch``: (images (B, H, W, 3) fp32, labels
    (B,) int32) numpy arrays, class prototypes plus noise."""
    rng = np.random.default_rng(np.random.PCG64([cfg.seed + 1, step]))
    labels = rng.integers(0, cfg.num_classes, size=(cfg.batch,))
    protos = _prototypes(cfg.seed, cfg.num_classes, cfg.image)
    x = protos[labels] + cfg.noise * rng.normal(
        size=(cfg.batch, cfg.image, cfg.image, 3))
    return x.astype(np.float32), labels.astype(np.int32)


def image_batch(cfg: ImageTaskConfig, step: int, *, device=None):
    """Class-conditional blobs of ``step``: (images (B, H, W, 3) fp32,
    labels (B,) int64) on ``device`` (the card unless another is named),
    the reference's values bit for bit."""
    device = resolve_device(device)
    x, labels = _image_arrays(cfg, step)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(labels).long().to(device))


def image_stream(cfg: ImageTaskConfig, *, device=None, start: int = 0):
    """An iterator of (step, {"images", "labels"}) from ``image_batch``,
    on ``device`` (the card unless another is named)."""
    return _image_stream(cfg, resolve_device(device), start)


def _image_stream(cfg: ImageTaskConfig, device, step: int):
    while True:
        images, labels = image_batch(cfg, step, device=device)
        yield step, {"images": images, "labels": labels}
        step += 1
