"""Train and serve steps of the LM.

Counterpart of ``src/repro/train/step.py``: the single-device
pre-generating training step (``lm_train_step`` with ``pregen=True``,
``init_train_state``, ``state_core``) and the serving steps
(``lm_prefill_step`` with ``last_index``, ``lm_decode_step`` with
``per_slot=True``).

What differs: no mesh, activation sharding, compressed gradient sync
or modality prefix; no step builder (``functools.partial`` of
``lm_train_step`` is the step function); decode is per-slot only
(``pos`` is a (B,) vector of per-request positions); the legacy
``pregen=False`` dataflow is not ported.  Gradients are taken with
``torch.autograd.grad`` on the compute tree's float leaves, so nothing
accumulates in ``.grad`` between steps.  The step's three parts are
profiler ranges ``train/forward``, ``train/backward`` (which includes the
blocks' recompute) and ``train/update``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models import transformer_lm as T
from repro_torch.optim import sgd


def init_train_state(cfg, sp_cfg, *, seed: int = 0, device=None,
                     pregen_pack: bool = True):
    """Random fp32 params from ``seed`` on ``device`` (the card unless
    another is named), the optimizer state, and the pre-generated
    compute tree of their masks (``sp_cfg``; packed with
    ``pregen_pack``)."""
    params = T.init(cfg, seed=seed, device=device, dtype=torch.float32)
    return train_state_from_params(params, sp_cfg, pregen_pack=pregen_pack)


def train_state_from_params(params, sp_cfg, *, pregen_pack: bool = True):
    """The train state of ``params``, on their device; fp32 params are
    taken over as the master."""
    state = sgd.init_state(params)
    state["compute"] = sgd.pregen_tree(state["master"], sp_cfg,
                                       pack=pregen_pack)
    return state


def state_core(state):
    return {k: state[k] for k in ("master", "momentum", "step")}


def lm_train_step(state, batch, *, cfg, sp_cfg, opt_cfg,
                  pregen_pack: bool = True):
    """One BDWP training step on ``state["compute"]``: FF on the
    pre-generated (packed) operands, BP on ``bp``, the dense WU gradient
    on ``bp``'s gradient, then ``sgd.update``, which writes the next
    compute tree.  Returns (new_state, {"loss", "lr"}); consumes
    ``state`` (see ``sgd.update``)."""
    compute = state["compute"]
    roots = sgd.diff_leaves(compute)
    for r in roots:
        r.requires_grad_(True)
    try:
        with record_function("train/forward"):
            hidden, _ = T.forward(compute, batch["tokens"], cfg, sp_cfg)
            loss = T.lm_loss(compute, hidden, batch["labels"], cfg)
        with record_function("train/backward"):
            grads = torch.autograd.grad(loss, roots, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for r in roots:
            r.requires_grad_(False)
    del hidden
    with torch.no_grad(), record_function("train/update"):
        new_state, new_compute = sgd.update(
            state_core(state), sgd.pregen_grads(compute, grads), opt_cfg,
            sp_cfg, prev_compute=compute, pack=pregen_pack)
    new_state["compute"] = new_compute
    metrics = {"loss": loss.detach(),
               "lr": sgd.lr_schedule(opt_cfg, state["step"])}
    return new_state, metrics


def lm_prefill_step(params, batch, *, cfg, sp_cfg, last_index=None,
                    cache_dtype=torch.bfloat16):
    """Prefill: build the KV cache and return next-token logits (B, 1, V).

    last_index: optional (B,) indices of each request's last real token;
    right-padded prompts read their logits there instead of at s-1.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = T.init_lm_cache(cfg, b, s, device=tokens.device,
                            dtype=cache_dtype)
    hidden, cache = T.forward(params, tokens, cfg, sp_cfg, cache=cache)
    if last_index is None:
        h_last = hidden[:, -1:]
    else:
        idx = torch.as_tensor(last_index, device=tokens.device).reshape(b)
        h_last = hidden[torch.arange(b, device=tokens.device), idx][:, None]
    return T.logits_from_hidden(params, h_last, cfg), cache


def lm_decode_step(params, cache, token, pos, *, cfg, sp_cfg):
    """One per-slot decode step: token (B, 1), pos (B,) — row i writes
    its KV at pos[i] and attends to positions <= pos[i].  The cache is
    updated in place and returned."""
    b = token.shape[0]
    positions = torch.as_tensor(pos, device=token.device).reshape(b, 1)
    hidden, cache = T.forward(params, token, cfg, sp_cfg, cache=cache,
                              decode=True, positions=positions)
    return T.logits_from_hidden(params, hidden, cfg), cache
