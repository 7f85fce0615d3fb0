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
or mvue, seeded by the step) before ``sgd.update``.  The P pods are all
on this device; one process a pod is the mesh step at "pod" = P
(``build_lm_train``).

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

``build_lm_train`` and ``build_encdec_train`` (with
``StepBundle``, ``abstract_compute_tree`` and ``_train_state_pspecs``)
resolve the TRAIN rules over a ``launch.mesh.Mesh`` of processes and
return a bundle whose step runs on the rank's blocks of the state
(``sharding.fsdp``): the model gathers each block's operands where it
reads them, the gradients are reduced to blocks over "data", then
averaged over "pod" (the compressed sync with ``compress``, its packed
payloads over the "pod" group, each rank compressing its own blocks
with its own residual columns; else a dense mean), and ``sgd.update``
runs on the blocks.  Each rank gets its own rows of the global batch
(``data.synthetic``'s ``rows=``); the MoE layers route and take their
load-balance loss over the whole batch of the program they stand for
(``fsdp.token_split``: the pod's rows with ``compress``, else every
rank's), as the reference's one SPMD program does.  At "pod" = P and
"data" = 1 this is the process form of the compressed sync, one pod a
process, bitwise ``lm_train_step``'s P pods in one process.
``build_lm_serve`` resolves the SERVE_BATCH rules the same way and
returns the synchronized-batch prefill or decode over a mesh, masked
or from shared-pattern packed weights (``bdwp.pack_tree_shared(
pspecs=)``): the rank's rows over the DP axes, its weight blocks over
"model" (a row-parallel ``SharedOp``'s rows rebased to its K block,
``sharding.tp``), the whole batch's logits on every rank.
``restore_with_pregen`` upgrades checkpoints of the two older dataflow
generations (no compute tree; MoE expert stacks still plain bf16
copies) by regenerating the compute tree from the restored master.

What differs: a training mesh with "model" > 1 raises
NotImplementedError (tensor and expert parallelism in training, and
sequence parallelism there, are ROADMAP item 7, the training side;
``seq_parallel`` is accepted and changes nothing at "model" = 1, as in
the reference); the serve steps ``lm_prefill_step`` and
``lm_decode_step`` take ``mesh=`` as the reference's do and execute a
"model" axis of M > 1 ranks on the rank's blocks (``sharding.tp``,
the dense attention LMs) and the rows they are given (the DP axes cut
them outside: ``build_lm_serve``, the engine); ``build_lm_serve(
long_context=True)`` raises NotImplementedError (ROADMAP item 7.2b:
the cache's sequence over "data"); no activation sharding (``act``: explicit
collectives stand at its points); the bundle's step is a Python
function, not a compiled one, and ``donate`` has no counterpart (the
update consumes the state anyway); with one rank the bundle's step is
``lm_train_step`` itself; ``lm_decode_step`` defaults to per-slot
decode (``pos`` a (B,) vector of per-request positions, the serve
engine's mode), where the reference defaults to the shared cursor
(``per_slot=False``, ``pos`` one position for the batch). Gradients are
taken with ``torch.autograd.grad`` on the float leaves the model reads,
so nothing accumulates in ``.grad`` between steps. The step's parts are
profiler ranges ``train/forward``, ``train/backward`` (which includes
the blocks' recompute), ``train/sync`` (compressed steps only) and
``train/update``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.profiler import record_function

from repro_torch.core.operand import PregenOp
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import DP_AXES
from repro_torch.models import convnets as CN
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer_lm as T
from repro_torch.optim import compress as C
from repro_torch.optim import sgd
from repro_torch.sharding import fsdp as F
from repro_torch.sharding import rules as R
from repro_torch.sharding import tp

AUX_COEF = 0.01     # weight of the MoE load-balance loss in the total


def init_train_state(cfg, sp_cfg, *, seed: int = 0, device=None,
                     pregen: bool = True, pregen_pack: bool = True,
                     compress: bool = False, n_pods: int = 1, mesh=None):
    """Random fp32 params from ``seed`` on ``device`` (the card unless
    another is named), of an LM or, for an ``EncDecConfig``, of the
    encoder-decoder; the optimizer state, and with ``pregen`` the
    pre-generated compute tree of their masks (``sp_cfg``; packed with
    ``pregen_pack``).  ``compress`` adds the zero error-feedback
    residual ``err`` of ``n_pods`` pods, (n_pods, err_state_elems)
    fp32.

    With ``mesh`` (a ``launch.mesh.Mesh``), this rank's blocks of that
    state under the TRAIN rules: an LM's params are drawn a layer at a
    time and cut at once, so no rank holds the whole model (the same
    bits as ``fsdp.shard_tree`` of the whole draw); ``err`` is the
    rank's (1, local width) row, and ``n_pods`` is the mesh's."""
    model = E if isinstance(cfg, E.EncDecConfig) else T
    if mesh is None or mesh.size == 1:
        params = model.init(cfg, seed=seed, device=device,
                            dtype=torch.float32)
        return train_state_from_params(params, sp_cfg, pregen=pregen,
                                       pregen_pack=pregen_pack,
                                       compress=compress, n_pods=n_pods)
    specs = state_pspecs(cfg, mesh, sp_cfg, compress=False, pregen=False)
    cut = functools.partial(F.shard_tree, mesh=mesh)
    if model is T:
        device = resolve_device(device)
        gen = T.generator(seed, device)
        shell = T.init_shell(cfg, gen, device=device)
        params = cut({k: v for k, v in shell.items()},
                     {k: specs["master"][k] for k in shell})
        params["blocks"] = [cut(b, s) for b, s in zip(
            T.iter_blocks(cfg, gen, device=device),
            specs["master"]["blocks"])]
    else:
        params = cut(E.init(cfg, seed=seed, device=device,
                            dtype=torch.float32), specs["master"])
    lshapes = sgd.shapes_of(T.abstract_params(cfg) if model is T
                            else E.abstract_params(cfg))
    state = train_state_from_params(params, sp_cfg, pregen=pregen,
                                    pregen_pack=pregen_pack,
                                    lshapes=lshapes)
    if compress and "pod" in mesh.axis_names:
        state["err"] = C.init_err(state["master"], 1, sp_cfg.m)
    return state


def train_state_from_params(params, sp_cfg, *, pregen: bool = True,
                            pregen_pack: bool = True,
                            compress: bool = False, n_pods: int = 1,
                            lshapes=None):
    """The train state of ``params``, on their device; fp32 params are
    taken over as the master.  Without ``pregen`` it holds no compute
    tree.  ``lshapes``: the logical shapes of a rank's blocks
    (``sgd.pregen_tree``)."""
    state = sgd.init_state(params)
    if compress:
        state["err"] = C.init_err(state["master"], n_pods, sp_cfg.m)
    if pregen:
        state["compute"] = sgd.pregen_tree(state["master"], sp_cfg,
                                           pack=pregen_pack, lshapes=lshapes)
    return state


def state_core(state):
    return {k: state[k] for k in ("master", "momentum", "step")}


def _bf16_cast(master):
    """The legacy dataflow's compute tree: the bf16 cast of the master."""
    return sgd.tree_map(lambda _, w: w.to(torch.bfloat16)
                        if w.is_floating_point() else w, master)


def lm_train_step(state, batch, *, cfg, sp_cfg, opt_cfg,
                  pregen: bool = True, pregen_pack: bool = True,
                  compress: bool = False, n_pods: int = 1, grad_sync=None):
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
    over the ``n_pods`` pods, all on this device.  Returns (new_state,
    {"loss", "aux", "total", "lr"}); consumes ``state`` (see
    ``sgd.update``, ``cross_pod_sync``).
    """
    compute = state["compute"] if pregen else _bf16_cast(state["master"])
    roots = sgd.diff_leaves(compute)
    pods = n_pods if compress else 1
    rows = batch["tokens"].shape[0]
    if rows % pods:
        raise ValueError(f"global batch {rows} not divisible by "
                         f"n_pods={pods}")
    per = rows // pods
    losses, auxes, totals, stacked = [], [], [], None
    for r in roots:
        r.requires_grad_(True)
    try:
        for p in range(pods):
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
                        (pods, *g.shape),
                        dtype=g.dtype if pregen else torch.float32)
                        for g in grads]
                for s, g in zip(stacked, grads):
                    s[p].copy_(g)
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
                step=int(state["step"]))
            del stacked
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


def _update(state, grads, loss, *, opt_cfg, sp_cfg, pregen, pregen_pack,
            lshapes=None):
    """``sgd.update`` of ``state`` with master-shaped ``grads`` (range
    ``train/update``): the new state, with the next compute tree if
    ``pregen``, and the step's {"loss", "lr"}.  ``lshapes``: the
    logical shapes of a rank's blocks."""
    with torch.no_grad(), record_function("train/update"):
        new_state, new_compute = sgd.update(
            state_core(state), grads, opt_cfg, sp_cfg,
            prev_compute=state.get("compute"), pregen=pregen,
            pack=pregen_pack, lshapes=lshapes)
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
                    cache_dtype=torch.bfloat16, mesh=None):
    """Prefill: build the KV cache and return next-token logits (B, 1, V).

    last_index: optional (B,) indices of each request's last real token;
    right-padded prompts read their logits there instead of at s-1.
    With ``batch["prefix_embeds"]`` (B, S_pre, d) the cache covers the
    S_pre + S positions of prefix and text, and ``last_index`` counts
    from the prefix's first position.  With a ``mesh`` whose "model"
    axis has M > 1 ranks, ``params`` are the rank's blocks
    (``sharding.tp``): the step runs inside ``tp.model_split``, builds
    the rank's block of the cache (its heads of the rows it is given)
    and returns whole-vocab logits.  Over the DP axes the step runs
    the rows it is given: the caller's (``build_lm_serve``, the engine)
    cut them.
    """
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    b, s = tokens.shape
    s_tot = s + (prefix.shape[1] if prefix is not None else 0)
    split = tp.serve_split(cfg, mesh)
    if split is None:
        cache = T.init_lm_cache(cfg, b, s_tot, device=tokens.device,
                                dtype=cache_dtype)
    else:
        cache = tp.init_cache(cfg, b, s_tot, mesh, device=tokens.device,
                              dtype=cache_dtype)
    with tp.model_split(split):
        hidden, cache, _ = T.forward(params, tokens, cfg, sp_cfg,
                                     prefix_embeds=prefix, cache=cache)
        if last_index is None:
            h_last = hidden[:, -1:]
        else:
            idx = torch.as_tensor(last_index,
                                  device=tokens.device).reshape(b)
            h_last = hidden[torch.arange(b, device=tokens.device),
                            idx][:, None]
        return T.logits_from_hidden(params, h_last, cfg), cache


def lm_decode_step(params, cache, token, pos, *, cfg, sp_cfg,
                   per_slot: bool = True, mesh=None):
    """One decode step on token (B, 1).  Per slot: pos (B,), row i writes
    its KV at pos[i] and attends to positions <= pos[i].  With
    ``per_slot=False`` (the synchronized batch): pos is one position,
    the rows' RoPE position, and every row writes at the cache's shared
    cursor ``pos`` entry and attends to the positions up to it.  The
    cache is updated in place and returned.  With a ``mesh`` whose
    "model" axis has M > 1 ranks, ``params`` and ``cache`` are the
    rank's blocks and the logits come back whole, as
    ``lm_prefill_step``'s."""
    b = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device)
    positions = (pos.reshape(b, 1) if per_slot
                 else pos.reshape(1, 1).expand(b, 1))
    split = tp.serve_split(cfg, mesh)
    with tp.model_split(split):
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


# ---------------------------------------------------------------------------
# build_lm_train and build_encdec_train: the TRAIN rules over a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepBundle:
    """A built step.  Training: ``step_fn(state, batch)`` takes this
    rank's blocks of the state and its rows of the global batch;
    ``state_shardings`` (a ``sharding.fsdp.StateSharding``) holds the
    state's resolved spec tree (``.specs``: "master", "momentum",
    "step", and "compute" / "err" where the state has them) and cuts or
    gathers a state by it; ``input_pspecs`` are the batch's specs,
    ``names`` the master's leaf names, ``specs`` its logical-axis tree
    and ``lshapes`` its logical shapes.  Serving (``build_lm_serve``):
    ``state_shardings`` is the params' spec tree and ``names`` empty, as
    the reference's."""
    step_fn: callable
    state_shardings: object
    input_pspecs: dict
    names: list
    specs: object
    mesh: object = None
    lshapes: object = None

    def init_state(self, cfg, sp_cfg, *, seed: int = 0, device=None,
                   compress: bool = False):
        """This rank's blocks of a fresh train state for the bundle."""
        sh = self.state_shardings
        return init_train_state(
            cfg, sp_cfg, seed=seed, device=device,
            pregen="compute" in sh.specs, pregen_pack=sh.pregen_pack,
            compress=compress and "err" in sh.specs, mesh=self.mesh)


def check_mesh(mesh):
    """Refuse a mesh whose "model" axis has more than one rank."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh {dict(mesh.shape)}: a 'model' axis of more than one rank "
            "(tensor and expert parallelism, and sequence parallelism over "
            "'model') in training is ROADMAP item 7, part 3, the training "
            "side; training runs 'data' (FSDP) and 'pod' only")


def abstract_compute_tree(aparams, sp_cfg, pack=False):
    """The compute tree of an abstract master (meta tensors): shapes and
    structure, nothing allocated."""
    return sgd.pregen_tree(aparams, sp_cfg, pack=pack)


def _train_state_pspecs(p_pspecs, aparams, mesh, sp_cfg, *, compress,
                        pregen, pregen_pack):
    """State specs with the pre-generated compute tree's; asserts that
    no resolved spec of master or compute splits an N:M group or a
    packed run."""
    R.assert_nm_unsplit(p_pspecs, aparams, mesh, sp_cfg)
    state_pspecs = {"master": p_pspecs, "momentum": p_pspecs, "step": ()}
    if compress and "pod" in mesh.axis_names:
        state_pspecs["err"] = R.grad_sync_pspecs(mesh)["err"]
    if pregen:
        acompute = abstract_compute_tree(aparams, sp_cfg, pack=pregen_pack)
        c_pspecs = R.pregen_pspecs(acompute, p_pspecs)
        R.assert_nm_unsplit(c_pspecs, acompute, mesh, sp_cfg)
        state_pspecs["compute"] = c_pspecs
    return state_pspecs


def _model_of(cfg):
    return E if isinstance(cfg, E.EncDecConfig) else T


def state_pspecs(cfg, mesh, sp_cfg, *, compress=False, pregen=True,
                 pregen_pack=True):
    """The resolved state spec tree of ``cfg`` on ``mesh`` (TRAIN
    rules, the group guard asserted)."""
    model = _model_of(cfg)
    aparams = model.abstract_params(cfg)
    p_pspecs = R.nm_params_pspecs(model.init_specs(cfg), R.TRAIN_RULES,
                                  aparams, mesh, sp_cfg)
    return _train_state_pspecs(p_pspecs, aparams, mesh, sp_cfg,
                               compress=compress, pregen=pregen,
                               pregen_pack=pregen_pack)


def _metric_means(values, mesh):
    """Each metric's mean over every rank of ``mesh`` (rank order)."""
    if mesh.size == 1:
        return values
    import torch.distributed as dist

    rows = C.gather_rows(torch.stack(values).to(torch.float32)[None],
                         dist.group.WORLD, count=False)
    return [rows[:, j].mean() for j in range(len(values))]


def sharded_train_step(state, batch, *, losses, mesh, shardings, sp_cfg,
                       opt_cfg, pregen: bool = True,
                       pregen_pack: bool = True, compress: bool = False,
                       grad_sync=None, rows_only=()):
    """One training step on this rank's blocks ``state`` and rows
    ``batch``.  ``losses(tree, batch)`` gives [total, loss] (an LM also
    aux) on the tree the model reads (``fsdp.step_view``: blocks
    gathered where they are read); the gradients of ``total`` come back
    reduced to blocks over "data" (their data mean), then the pod mean:
    the compressed sync over the "pod" group with ``compress`` (the
    rank's blocks and its residual row), else a dense mean; then
    ``sgd.update`` on the blocks.  The metrics are means over every
    rank.  Consumes ``state``."""
    specs = shardings.specs
    compute = state["compute"] if pregen else _bf16_cast(state["master"])
    roots = sgd.diff_leaves(compute)
    split = F.token_split(mesh, ("data",) if compress else DP_AXES)
    for r in roots:
        r.requires_grad_(True)
    try:
        view = F.step_view(compute, specs["compute"] if pregen
                           else specs["master"], mesh, rows_only)
        with L.token_split(split):
            with record_function("train/forward"):
                values = losses(view, batch)
            with record_function("train/backward"):
                grads = torch.autograd.grad(values[0], roots,
                                            allow_unused=True,
                                            materialize_grads=True)
        del view
    finally:
        for r in roots:
            r.requires_grad_(False)
    grads = sgd.pregen_grads(compute, grads)
    del compute, roots
    new_err = None
    with torch.no_grad(), record_function("train/sync"):
        if compress:
            stacked = sgd.tree_map(lambda _, g: (
                g if pregen else g.to(torch.float32))[None], grads)
            del grads
            gc_cfg = grad_sync or C.GradCompressConfig.from_sparsity(sp_cfg)
            grads, new_err = C.cross_pod_sync(
                stacked, state["err"], gc_cfg, step=int(state["step"]),
                group=mesh.group("pod"))
            del stacked
        elif mesh.shape.get("pod", 1) > 1:
            grads = F.reduce_tree(grads, specs["master"], mesh, "pod")
    values = _metric_means([v.detach() for v in values], mesh)
    new_state, metrics = _update(state, grads, values[1], opt_cfg=opt_cfg,
                                 sp_cfg=sp_cfg, pregen=pregen,
                                 pregen_pack=pregen_pack,
                                 lshapes=shardings.lshapes)
    if len(values) > 2:
        metrics.update(aux=values[2], total=values[0])
    if new_err is not None:
        new_state["err"] = new_err
    return new_state, metrics


def _lm_losses(tree, batch, *, cfg, sp_cfg):
    prefix = batch.get("prefix_embeds")
    hidden, _, aux = T.forward(tree, batch["tokens"], cfg, sp_cfg,
                               prefix_embeds=prefix)
    if prefix is not None:   # the loss reads the text only
        hidden = hidden[:, prefix.shape[1]:]
    loss = T.lm_loss(tree, hidden, batch["labels"], cfg)
    return [loss + AUX_COEF * aux, loss, aux]


def _encdec_losses(tree, batch, *, cfg, sp_cfg):
    enc = E.encode(tree, batch["frames"], cfg, sp_cfg)
    hidden, _ = E.decode(tree, batch["tokens"], enc, cfg, sp_cfg)
    loss = E.loss(tree, hidden, batch["labels"], cfg)
    return [loss, loss]


def _names(tree) -> list:
    out = []
    sgd.tree_map(lambda name, _: out.append(name), tree)
    return out


def _bundle(cfg, mesh, sp_cfg, *, compress, pregen, pregen_pack):
    check_mesh(mesh)
    model = _model_of(cfg)
    aparams, specs = model.abstract_params(cfg), model.init_specs(cfg)
    p_pspecs = R.nm_params_pspecs(specs, R.TRAIN_RULES, aparams, mesh,
                                  sp_cfg)
    st = _train_state_pspecs(p_pspecs, aparams, mesh, sp_cfg,
                             compress=compress, pregen=pregen,
                             pregen_pack=pregen_pack)
    lshapes = sgd.shapes_of(aparams)
    sh = F.StateSharding(mesh, st, lshapes, sp_cfg.m, pregen_pack)
    dp = R.batch_axes(mesh)
    return sh, specs, _names(aparams), dp[0] if len(dp) == 1 else dp


def build_lm_train(cfg, mesh, sp_cfg, opt_cfg, *, compress=False,
                   donate=True, seq_parallel=False, pregen=True,
                   pregen_pack=True, grad_sync=None) -> StepBundle:
    """The LM's training step on ``mesh`` under the TRAIN rules: FSDP
    over "data", the (compressed, with ``compress`` and a "pod" axis)
    pod mean over "pod".  ``donate`` and ``seq_parallel`` (at "model" =
    1) change nothing.  With one rank the step is ``lm_train_step``."""
    del donate, seq_parallel
    compress = compress and "pod" in mesh.axis_names
    sh, specs, names, dp = _bundle(cfg, mesh, sp_cfg, compress=compress,
                                   pregen=pregen, pregen_pack=pregen_pack)
    in_pspecs = {"tokens": (dp, None), "labels": (dp, None)}
    if cfg.name.startswith("internvl"):
        in_pspecs["prefix_embeds"] = (dp, None, None)
    if mesh.size == 1:
        fn = functools.partial(lm_train_step, cfg=cfg, sp_cfg=sp_cfg,
                               opt_cfg=opt_cfg, pregen=pregen,
                               pregen_pack=pregen_pack, compress=compress,
                               grad_sync=grad_sync)
    else:
        fn = functools.partial(
            sharded_train_step, losses=functools.partial(
                _lm_losses, cfg=cfg, sp_cfg=sp_cfg), mesh=mesh, shardings=sh,
            sp_cfg=sp_cfg, opt_cfg=opt_cfg, pregen=pregen,
            pregen_pack=pregen_pack, compress=compress, grad_sync=grad_sync,
            rows_only=() if cfg.tie_embed else ("embed",))
    return StepBundle(fn, sh, in_pspecs, names, specs, mesh, sh.lshapes)


def build_encdec_train(cfg, mesh, sp_cfg, opt_cfg, donate=True,
                       pregen=True, pregen_pack=True) -> StepBundle:
    """The encoder-decoder's training step on ``mesh`` (FSDP over
    "data", a dense pod mean over "pod"; no compressed sync, as the
    reference's)."""
    del donate
    sh, specs, names, dp = _bundle(cfg, mesh, sp_cfg, compress=False,
                                   pregen=pregen, pregen_pack=pregen_pack)
    in_pspecs = {"frames": (dp, None, None), "tokens": (dp, None),
                 "labels": (dp, None)}
    if mesh.size == 1:
        fn = functools.partial(encdec_train_step, cfg=cfg, sp_cfg=sp_cfg,
                               opt_cfg=opt_cfg, pregen=pregen,
                               pregen_pack=pregen_pack)
    else:
        fn = functools.partial(
            sharded_train_step, losses=functools.partial(
                _encdec_losses, cfg=cfg, sp_cfg=sp_cfg), mesh=mesh,
            shardings=sh, sp_cfg=sp_cfg, opt_cfg=opt_cfg, pregen=pregen,
            pregen_pack=pregen_pack)
    return StepBundle(fn, sh, in_pspecs, names, specs, mesh, sh.lshapes)


# ---------------------------------------------------------------------------
# build_lm_serve: the synchronized batch over a mesh
# ---------------------------------------------------------------------------

_LONG_CONTEXT = ("ROADMAP item 7.2b: long-context decode, the cache's "
                 "sequence over 'data' (SERVE_LONG_RULES)")


def build_lm_serve(cfg, mesh, sp_cfg, input_specs, *, long_context=False,
                   prefill=False, packed=False) -> StepBundle:
    """The LM's serve step on ``mesh`` under the SERVE_BATCH rules: the
    synchronized batch (one shared cursor ``pos``), its rows over the DP
    axes, the weights TP over "model" (the dense attention LMs;
    ``sharding.tp.check_serve``).  ``state_shardings`` is the params'
    spec tree: with ``packed`` the shared-pattern tree's
    (``bdwp.pack_tree_shared(pspecs=)``), asserted group-safe; cut a
    whole (packed) tree to the rank's blocks with ``tp.serve_blocks``.
    ``input_pspecs`` are ``rules.serve_input_pspecs`` of
    ``input_specs`` (meta tensors), whose batch (``tokens`` with
    ``prefill``, else ``token``) D must divide, as the reference's
    shardings demand (ValueError).  ``step_fn(params, batch)`` with
    ``prefill``, else ``step_fn(params, cache, token, pos)``, takes the
    rank's param blocks, its rows of the batch and its block of the
    cache; it returns the whole batch's logits on every rank (gathered
    over the DP group, the reference's ``out_shardings=(None, ...)``)
    and the rank's block of the cache.  ``long_context`` raises
    (ROADMAP item 7.2b)."""
    if long_context:
        raise NotImplementedError(f"build_lm_serve(long_context=True): "
                                  f"{_LONG_CONTEXT}, is not ported")
    tp.check_serve(cfg, mesh)
    batch = input_specs.get("tokens" if prefill else "token")
    n = None if batch is None else batch.shape[0]
    if n is not None and n % mesh.dp_size:
        raise ValueError(f"build_lm_serve: a batch of {n} rows does not "
                         f"divide over the {mesh.dp_size} DP ranks of mesh "
                         f"{dict(mesh.shape)}")
    aparams, specs = T.abstract_params(cfg), T.init_specs(cfg)
    p_pspecs = R.nm_params_pspecs(specs, R.SERVE_BATCH_RULES, aparams, mesh,
                                  sp_cfg)
    check_tree = aparams
    if packed:
        from repro_torch.core import bdwp

        check_tree, p_pspecs = bdwp.pack_tree_shared(aparams, sp_cfg,
                                                     pspecs=p_pspecs)
    R.assert_nm_unsplit(p_pspecs, check_tree, mesh, sp_cfg)
    in_pspecs = R.serve_input_pspecs(input_specs, mesh, long_context=False)
    fn = functools.partial(_serve_step, cfg=cfg, sp_cfg=sp_cfg, mesh=mesh,
                           prefill=prefill, n=n)
    return StepBundle(fn, p_pspecs, in_pspecs, [], specs, mesh)


def _serve_step(params, *args, cfg, sp_cfg, mesh, prefill, n):
    """``build_lm_serve``'s step on the rank's block of the ``n`` rows
    over the DP axes (its MoE routing groups over all of them)."""
    rows = (args[0]["tokens"] if prefill else args[1]).shape[0]
    if n is None or rows * mesh.dp_size != n:
        raise ValueError(f"build_lm_serve's step takes a rank's block of "
                         f"the batch its input specs give ({n} rows over "
                         f"{mesh.dp_size} DP ranks), not {rows} rows")
    with L.token_split(tp.rows_split(mesh, n)):
        if prefill:
            logits, cache = lm_prefill_step(params, args[0], cfg=cfg,
                                            sp_cfg=sp_cfg, mesh=mesh)
        else:
            logits, cache = lm_decode_step(params, *args, cfg=cfg,
                                           sp_cfg=sp_cfg, per_slot=False,
                                           mesh=mesh)
    return tp.gather_rows(logits, tp.slot_split(mesh, n)), cache


def _meta(tree):
    return sgd.tree_map(lambda _, x: torch.empty(
        x.shape, dtype=x.dtype, device="meta"), tree)


def _structure(node):
    """A tree's structure: keys, list lengths, operand fields."""
    if isinstance(node, dict):
        return {k: _structure(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_structure(v) for v in node]
    if isinstance(node, PregenOp):
        return ("PregenOp",) + tuple(getattr(node, f) is not None
                                     for f in F.PREGEN_FIELDS)
    return "leaf"


def restore_with_pregen(mgr, like_state, step=None, shardings=None, *,
                        sp_cfg=None, pregen_pack: bool = True,
                        device=None):
    """Checkpoint restore that upgrades older-dataflow checkpoints.

    Two generations mismatch today's state tree: no ``compute`` at all,
    and a compute tree whose bare MoE expert stacks are plain bf16
    copies (``sgd.pregen_tree(bare_sites=False)``).  Either way the rest
    (master, momentum, step, err) restores and the compute tree is
    regenerated from the restored master, a pure function of it, so the
    upgrade is exact.  ``shardings`` (a ``fsdp.StateSharding``) restores
    onto a mesh, each rank its blocks; ``device`` as
    ``CheckpointManager.restore``.  A checkpoint that matches neither
    raises the full-structure error."""
    try:
        return mgr.restore(like_state, step=step, device=device,
                           shardings=shardings)
    except ValueError as full_err:
        legacy_like = {k: v for k, v in like_state.items() if k != "compute"}
        legacy_sh = None if shardings is None else shardings.without(
            "compute")
        lshapes = None if shardings is None else shardings.lshapes
        attempts = [(legacy_like, legacy_sh)]
        if "compute" in like_state:
            old_compute = sgd.pregen_tree(
                _meta(legacy_like["master"]), sp_cfg, pack=pregen_pack,
                bare_sites=False, lshapes=lshapes)
            if _structure(old_compute) != _structure(like_state["compute"]):
                old_sh = None if shardings is None else shardings.with_specs(
                    compute=_old_compute_shardings(
                        old_compute, shardings.specs["master"]))
                attempts.append((dict(legacy_like, compute=old_compute),
                                 old_sh))
        restored = None
        for like, sh in attempts:
            try:
                restored = mgr.restore(like, step=step, device=device,
                                       shardings=sh)
                break
            except ValueError:
                continue
        if restored is None:
            raise full_err from None
        out = {k: v for k, v in restored.items() if k != "compute"}
        if "compute" in like_state:
            out["compute"] = sgd.pregen_tree(out["master"], sp_cfg,
                                             pack=pregen_pack,
                                             lshapes=lshapes)
        return out


def _old_compute_shardings(old_compute, master_specs):
    """Specs of a dict-sites-only compute tree: its dict sites take their
    master weight's spec in every operand field, as today's, and the
    bare expert stacks, plain copies there, the master weight's."""
    return R.pregen_pspecs(old_compute, master_specs)
