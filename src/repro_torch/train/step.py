"""Train and serve steps of the LM and the encoder-decoder, and the
training step of the paper's image models.

Counterpart of ``src/repro/train/step.py``: the training step
(``lm_train_step``, with or without the compressed cross-pod gradient
sync), ``init_train_state``, ``state_core``, and the serving steps
(``lm_prefill_step`` with ``last_index``, ``lm_decode_step`` with
``per_slot=True``), and the encoder-decoder's ``encdec_train_step``,
``encdec_prefill_step`` and ``encdec_decode_step``.
``init_image_train_state`` and ``image_train_step``
are the same step for ``models.convnets`` (ResNet9/18/50, VGG19, ViT),
which the reference composes inline (``sgd.pregen_tree``,
``convnets.*_apply``, the loss of ``examples/paper_loss_curves.py``,
``sgd.update``); ``image_loss_and_grads`` is its forward and backward
alone.

Both dataflows of the reference:
  * ``pregen=True``: FF and BP read the operands the previous update
    wrote (``state["compute"]``); gradients are taken on its float
    leaves (each ``PregenOp``'s ``bp`` carries the dense WU gradient);
  * ``pregen=False``, the legacy dataflow: the state keeps no compute
    tree and every matmul or conv re-derives its masks inside the model
    (a plain weight becomes a ``MaskedOp``).  The LM runs on the bf16
    cast of the master and its gradients are those of the bf16 leaves,
    cast to fp32 where the sync needs them (the bits of the reference's
    cast's gradient); an image model gets the fp32 master itself, as
    ``examples/paper_loss_curves.py`` passes it, so masks score fp32
    and the cast comes after masking.  This is the only dataflow on
    which ResNet18/50 train (their ``fc/w`` would become a
    ``PregenOp``).

With ``compress=True`` the step is the reference's pod-split step, for
every LM arch (dense, MoE with its aux loss, SSM and hybrid): the batch
is cut into P contiguous row blocks (``_pod_split_batch``), each pod
takes its loss and gradients on its block through the unchanged compute
tree (the reference vmaps ``value_and_grad`` over a pod-stacked copy),
the pod gradients are stacked (P, *shape), and
``optim.compress.cross_pod_sync`` gives their mean through packed N:M
payloads (topk, updating the error-feedback residual ``state["err"]``,
or mvue, seeded by the step) before ``sgd.update``.  The P pods are
either all on this device or one a process of a ``torch.distributed``
group (``group=``), which then holds its pod's rows and residual row.

A batch may carry ``prefix_embeds`` (B, S_pre, d), the stub frontend's
embeddings (internvl2): the model reads them before the tokens, the
loss is taken on the text positions only (``lm_train_step``), and
``lm_prefill_step`` builds its cache over prefix and text.

The encoder-decoder (``models.encdec``, whisper) trains on batches of
stub ``frames``, ``tokens`` and ``labels`` with the reference's loss,
the mean of ``logz - gold`` over every position, on either dataflow and
with no compressed sync (the reference's has none).  Its prefill
returns the logits, a cache exactly as long as the prompt, as the
reference's does (a decode step straight after it writes over the last
prompt position: seat the cache in a longer one first), and the encoder
output, which every decode step reads again.

What differs: no mesh or activation sharding; no step builder
(``functools.partial`` of ``lm_train_step`` is the step function);
``lm_decode_step`` defaults to per-slot decode (``pos`` a (B,) vector
of per-request positions, the serve engine's mode), where the
reference defaults to the shared cursor (``per_slot=False``, ``pos``
one position for the batch).  Gradients are taken with
``torch.autograd.grad`` on the float leaves the model reads, so nothing
accumulates in ``.grad`` between steps.  The step's parts are profiler
ranges ``train/forward``, ``train/backward`` (which includes the blocks'
recompute), ``train/sync`` (compressed steps only) and
``train/update``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models import convnets as CN
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer_lm as T
from repro_torch.optim import compress as C
from repro_torch.optim import sgd

AUX_COEF = 0.01     # weight of the MoE load-balance loss in the total


def init_train_state(cfg, sp_cfg, *, seed: int = 0, device=None,
                     pregen: bool = True, pregen_pack: bool = True,
                     compress: bool = False, n_pods: int = 1):
    """Random fp32 params from ``seed`` on ``device`` (the card unless
    another is named), of an LM or, for an ``EncDecConfig``, of the
    encoder-decoder; the optimizer state, and with ``pregen`` the
    pre-generated compute tree of their masks (``sp_cfg``; packed with
    ``pregen_pack``).  ``compress`` adds the zero error-feedback
    residual ``err`` of ``n_pods`` pods, (n_pods, err_state_elems)
    fp32."""
    model = E if isinstance(cfg, E.EncDecConfig) else T
    params = model.init(cfg, seed=seed, device=device, dtype=torch.float32)
    return train_state_from_params(params, sp_cfg, pregen=pregen,
                                   pregen_pack=pregen_pack,
                                   compress=compress, n_pods=n_pods)


def train_state_from_params(params, sp_cfg, *, pregen: bool = True,
                            pregen_pack: bool = True,
                            compress: bool = False, n_pods: int = 1):
    """The train state of ``params``, on their device; fp32 params are
    taken over as the master.  Without ``pregen`` it holds no compute
    tree."""
    state = sgd.init_state(params)
    if compress:
        state["err"] = C.init_err(state["master"], n_pods, sp_cfg.m)
    if pregen:
        state["compute"] = sgd.pregen_tree(state["master"], sp_cfg,
                                           pack=pregen_pack)
    return state


def state_core(state):
    return {k: state[k] for k in ("master", "momentum", "step")}


def _bf16_cast(master):
    """The legacy dataflow's compute tree: the bf16 cast of the master."""
    return sgd.tree_map(lambda _, w: w.to(torch.bfloat16)
                        if w.is_floating_point() else w, master)


def lm_train_step(state, batch, *, cfg, sp_cfg, opt_cfg,
                  pregen: bool = True, pregen_pack: bool = True,
                  compress: bool = False, n_pods: int = 1, grad_sync=None,
                  group=None):
    """One training step.  With ``pregen``: FF on the pre-generated
    (packed) operands of ``state["compute"]``, BP on ``bp``, the dense WU
    gradient on ``bp``'s gradient, then ``sgd.update``, which writes the
    next compute tree.  Without it: the model on the bf16 cast of the
    master, each matmul a ``MaskedOp`` that re-derives its masks, the
    gradients of the bf16 leaves, then ``sgd.update(pregen=False)``; the
    state keeps no compute tree.  The gradient is that of ``loss +
    AUX_COEF * aux``, aux the MoE load-balance loss summed over layers (0
    for a model without experts).

    With ``compress`` the gradient is the compressed pod mean of the
    pods' gradients (``grad_sync``, a ``GradCompressConfig``; by default
    topk at ``sp_cfg``'s n:m, the reference's buckets; fp32 gradients on
    the legacy dataflow, as the reference's master gives), each pod's
    loss, aux and total taken on its own rows, and the step's the mean
    over the pods.  Either all ``n_pods`` pods on this device, or, with
    ``group`` (a ``torch.distributed`` group, one process per pod), this
    process's pod alone: it takes its rank's rows of the global batch,
    holds its (1, width) row of the residual, and returns the same loss,
    aux, total and shared state as every other rank.  Returns
    (new_state, {"loss", "aux", "total", "lr"}); consumes ``state`` (see
    ``sgd.update``, ``cross_pod_sync``).
    """
    compute = state["compute"] if pregen else _bf16_cast(state["master"])
    roots = sgd.diff_leaves(compute)
    if compress and group is not None:
        import torch.distributed as dist

        pods, mine = dist.get_world_size(group), [dist.get_rank(group)]
        if n_pods not in (1, pods):
            raise ValueError(f"n_pods={n_pods} != the group's {pods}")
    else:
        pods = n_pods if compress else 1
        mine = list(range(pods))
    rows = batch["tokens"].shape[0]
    if rows % pods:
        raise ValueError(f"global batch {rows} not divisible by "
                         f"n_pods={pods}")
    per = rows // pods
    losses, auxes, totals, stacked = [], [], [], None
    for r in roots:
        r.requires_grad_(True)
    try:
        for row, p in enumerate(mine):
            rows_p = slice(p * per, (p + 1) * per)
            prefix = batch.get("prefix_embeds")
            with record_function("train/forward"):
                hidden, _, aux = T.forward(
                    compute, batch["tokens"][rows_p], cfg, sp_cfg,
                    prefix_embeds=None if prefix is None else prefix[rows_p])
                if prefix is not None:   # the loss reads the text only
                    hidden = hidden[:, prefix.shape[1]:]
                loss = T.lm_loss(compute, hidden, batch["labels"][rows_p],
                                 cfg)
                total = loss + AUX_COEF * aux
            with record_function("train/backward"):
                grads = torch.autograd.grad(total, roots, allow_unused=True,
                                            materialize_grads=True)
            del hidden
            losses.append(loss.detach())
            auxes.append(aux.detach())
            totals.append(total.detach())
            if compress:   # pod p's row of the pod-stacked gradients
                if stacked is None:
                    stacked = [g.new_empty(
                        (len(mine), *g.shape),
                        dtype=g.dtype if pregen else torch.float32)
                        for g in grads]
                for s, g in zip(stacked, grads):
                    s[row].copy_(g)
                del grads
    finally:
        for r in roots:
            r.requires_grad_(False)
    new_err = None
    if compress:
        with torch.no_grad(), record_function("train/sync"):
            gc_cfg = grad_sync or C.GradCompressConfig.from_sparsity(sp_cfg)
            grads, new_err = C.cross_pod_sync(
                sgd.pregen_grads(compute, stacked), state["err"], gc_cfg,
                step=int(state["step"]), group=group)
            del stacked
        if group is not None:   # every pod's (loss, aux, total), in order
            pod_vals = C.gather_rows(torch.stack(
                [losses[0], auxes[0], totals[0]]).to(torch.float32)[None],
                group, count=False)
            losses, auxes, totals = (list(pod_vals[:, j].unbind())
                                     for j in range(3))
    else:
        grads = sgd.pregen_grads(compute, grads)
    del compute, roots
    loss, aux, total = (torch.stack(v).mean() for v in (losses, auxes,
                                                         totals))
    new_state, metrics = _update(state, grads, loss, opt_cfg=opt_cfg,
                                 sp_cfg=sp_cfg, pregen=pregen,
                                 pregen_pack=pregen_pack)
    metrics.update(aux=aux, total=total)
    if new_err is not None:
        new_state["err"] = new_err
    return new_state, metrics


def _update(state, grads, loss, *, opt_cfg, sp_cfg, pregen, pregen_pack):
    """``sgd.update`` of ``state`` with master-shaped ``grads`` (range
    ``train/update``): the new state, with the next compute tree if
    ``pregen``, and the step's {"loss", "lr"}."""
    with torch.no_grad(), record_function("train/update"):
        new_state, new_compute = sgd.update(
            state_core(state), grads, opt_cfg, sp_cfg,
            prev_compute=state.get("compute"), pregen=pregen,
            pack=pregen_pack)
    if pregen:
        new_state["compute"] = new_compute
    return new_state, {"loss": loss.detach(),
                       "lr": sgd.lr_schedule(opt_cfg, state["step"])}


def encdec_train_step(state, batch, *, cfg, sp_cfg, opt_cfg,
                      pregen: bool = True, pregen_pack: bool = True):
    """One training step of the encoder-decoder on ``batch`` ({"frames"
    (B, T_enc, d), "tokens", "labels" (B, S)}): the encoder, the decoder
    and the loss on the compute tree (the pre-generated operands, or the
    bf16 cast of the master on the legacy dataflow), gradients of its
    float leaves mapped to the master's shape, then ``sgd.update``.
    Returns (new_state, {"loss", "lr"}); consumes ``state``."""
    def loss_fn(tree):
        enc = E.encode(tree, batch["frames"], cfg, sp_cfg)
        hidden, _ = E.decode(tree, batch["tokens"], enc, cfg, sp_cfg)
        return E.loss(tree, hidden, batch["labels"], cfg)

    loss, grads = _loss_and_grads(
        state["compute"] if pregen else _bf16_cast(state["master"]), loss_fn)
    return _update(state, grads, loss, opt_cfg=opt_cfg, sp_cfg=sp_cfg,
                   pregen=pregen, pregen_pack=pregen_pack)


def init_image_train_state(model: CN.ImageModel, sp_cfg, *, seed: int = 0,
                           device=None, pregen: bool = True,
                           pregen_pack: bool = True):
    """``init_train_state`` for one of the paper's image models: random
    fp32 params of ``model`` from ``seed`` on ``device`` (the card unless
    another is named), the optimizer state and, with ``pregen``, the
    pre-generated compute tree."""
    return train_state_from_params(CN.init(model, seed=seed, device=device),
                                   sp_cfg, pregen=pregen,
                                   pregen_pack=pregen_pack)


def image_train_step(state, batch, *, model: CN.ImageModel, sp_cfg, opt_cfg,
                     pregen: bool = True, pregen_pack: bool = True):
    """One step of an image model on ``batch`` ({"images" (B, H, W, 3),
    "labels" (B,)}): the forward on the bf16 images, the mean
    cross-entropy (``convnets.image_loss``), gradients of
    ``sgd.diff_leaves`` mapped to the master's shape, then
    ``sgd.update``.  With ``pregen`` the model reads
    ``state["compute"]`` and the update writes the next one; without it
    the model gets the fp32 master and re-derives its masks (the
    reference's ``examples/paper_loss_curves.py``).  Returns (new_state,
    {"loss", "lr"}); consumes ``state``."""
    loss, grads = image_loss_and_grads(
        state["compute"] if pregen else state["master"], batch, model=model,
        sp_cfg=sp_cfg)
    return _update(state, grads, loss, opt_cfg=opt_cfg, sp_cfg=sp_cfg,
                   pregen=pregen, pregen_pack=pregen_pack)


def image_loss_and_grads(tree, batch, *, model: CN.ImageModel, sp_cfg):
    """The forward and backward of ``image_train_step`` on ``tree`` (a
    compute tree, or the fp32 master on the legacy dataflow): (loss,
    master-shaped gradients of ``sgd.diff_leaves(tree)``)."""
    return _loss_and_grads(tree, lambda t: CN.image_loss(CN.apply(
        model, t, batch["images"].to(torch.bfloat16), sp_cfg),
        batch["labels"]))


def _loss_and_grads(tree, loss_fn):
    """(loss, master-shaped gradients) of ``loss_fn(tree)`` with respect
    to ``sgd.diff_leaves(tree)``: the forward under the profiler range
    ``train/forward``, the backward under ``train/backward``."""
    roots = sgd.diff_leaves(tree)
    for r in roots:
        r.requires_grad_(True)
    try:
        with record_function("train/forward"):
            loss = loss_fn(tree)
        with record_function("train/backward"):
            grads = torch.autograd.grad(loss, roots, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for r in roots:
            r.requires_grad_(False)
    return loss.detach(), sgd.pregen_grads(tree, grads)


def lm_prefill_step(params, batch, *, cfg, sp_cfg, last_index=None,
                    cache_dtype=torch.bfloat16):
    """Prefill: build the KV cache and return next-token logits (B, 1, V).

    last_index: optional (B,) indices of each request's last real token;
    right-padded prompts read their logits there instead of at s-1.
    With ``batch["prefix_embeds"]`` (B, S_pre, d) the cache covers the
    S_pre + S positions of prefix and text, and ``last_index`` counts
    from the prefix's first position.
    """
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    b, s = tokens.shape
    s_tot = s + (prefix.shape[1] if prefix is not None else 0)
    cache = T.init_lm_cache(cfg, b, s_tot, device=tokens.device,
                            dtype=cache_dtype)
    hidden, cache, _ = T.forward(params, tokens, cfg, sp_cfg,
                                 prefix_embeds=prefix, cache=cache)
    if last_index is None:
        h_last = hidden[:, -1:]
    else:
        idx = torch.as_tensor(last_index, device=tokens.device).reshape(b)
        h_last = hidden[torch.arange(b, device=tokens.device), idx][:, None]
    return T.logits_from_hidden(params, h_last, cfg), cache


def lm_decode_step(params, cache, token, pos, *, cfg, sp_cfg,
                   per_slot: bool = True):
    """One decode step on token (B, 1).  Per slot: pos (B,), row i writes
    its KV at pos[i] and attends to positions <= pos[i].  With
    ``per_slot=False`` (the synchronized batch): pos is one position,
    the rows' RoPE position, and every row writes at the cache's shared
    cursor ``pos`` entry and attends to the positions up to it.  The
    cache is updated in place and returned."""
    b = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device)
    positions = (pos.reshape(b, 1) if per_slot
                 else pos.reshape(1, 1).expand(b, 1))
    hidden, cache, _ = T.forward(params, token, cfg, sp_cfg, cache=cache,
                                 decode=True, positions=positions,
                                 per_slot=per_slot)
    return T.logits_from_hidden(params, hidden, cfg), cache


def encdec_prefill_step(params, batch, *, cfg, sp_cfg,
                        cache_dtype=torch.bfloat16):
    """Encode ``batch["frames"]`` and prefill the decoder with
    ``batch["tokens"]`` (B, S): returns (next-token logits (B, 1, V), the
    cache, the encoder output).  The cache is exactly S long, as the
    reference's (step.py's ``E.init_cache(cfg, b, s)``).  The decoder and
    the logits run under ``layers.batch_invariant``: on the card a row's
    bits are the same for every B of one bucket (1-8, ...)."""
    enc = E.encode(params, batch["frames"], cfg, sp_cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = E.init_cache(cfg, b, s, device=tokens.device, dtype=cache_dtype)
    with L.batch_invariant():
        hidden, cache = E.decode(params, tokens, enc, cfg, sp_cfg,
                                 cache=cache)
        logits = E.logits_from_hidden(params, hidden[:, -1:], cfg)
    return logits, cache, enc


def encdec_decode_step(params, cache, enc_out, token, pos, *, cfg, sp_cfg):
    """One decode step of token (B, 1) at the scalar position ``pos``
    (every row's learned position and RoPE), every row writing at each
    layer's shared cursor; the cross-attention K/V are projected from
    ``enc_out`` again.  The cache is updated in place and returned with
    the logits (B, 1, V).  Batch-invariant as ``encdec_prefill_step``."""
    b = token.shape[0]
    positions = torch.as_tensor(pos, device=token.device).reshape(
        1, 1).expand(b, 1)
    with L.batch_invariant():
        hidden, cache = E.decode(params, token, enc_out, cfg, sp_cfg,
                                 cache=cache, decode_step=True,
                                 positions=positions)
        return E.logits_from_hidden(params, hidden, cfg), cache
