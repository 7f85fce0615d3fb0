"""Serving steps: prefill and per-slot decode.

Counterpart of the serve half of ``src/repro/train/step.py``
(``lm_prefill_step`` with ``last_index``, ``lm_decode_step`` with
``per_slot=True``).  What differs: no mesh or activation sharding, no
modality prefix, and decode is per-slot only (``pos`` is a (B,) vector
of per-request positions); the training step is a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer_lm as T


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
