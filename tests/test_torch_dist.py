"""The process form of the compressed cross-pod sync: two gloo processes,
one pod each, against the one-tensor form (both pods on one device).

One spawn of two processes for the module (file-store init) runs every
case and saves what each rank saw; the parent computes the one-tensor
form and compares, bitwise:

1. ``cross_pod_sync`` on a tree with bf16 and fp32 leaves, a ragged
   leaf and a layer stack of ragged per-layer leaves (one unit), three
   rounds with topk (each rank's residual row carried) and mvue (each
   rank drawing pod ``rank``'s uniforms): the mean gradients and each
   rank's residual row;
2. three steps of ``build_lm_train`` on the mesh "pod=2" (one pod a
   process) of granite-moe-1b-a400m SMOKE (aux per pod) with topk and
   of qwen3-8b SMOKE with mvue, against ``lm_train_step``'s two pods in
   one process: loss, aux and total, each rank's residual row, and the
   shared state (equal on both ranks);
3. ``fit`` interrupted after step 2 and resumed from the mesh's
   checkpoint (the shared state once, the residual rows gathered) ends
   bitwise where the uninterrupted run ends;
4. the hop's bytes: a sync's gathers carry ``wire_bytes`` a pod.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_arch
from repro_torch.core import operand as TO
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.optim import compress as C
from repro_torch.optim import sgd as TSGD
from repro_torch.train import fault as TF
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR
from repro_torch.train.checkpoint import CheckpointManager

PODS, ROUNDS, BATCH, SEQ, STEPS = 2, 3, 4, 16, 3
SP = SparsityConfig(n=2, m=8, method="bdwp")
OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
RUNS = {"granite_topk": ("granite-moe-1b-a400m", "topk"),
        "qwen3_mvue": ("qwen3-8b", "mvue")}


def _tree_grads(seed: int):
    """Pod-stacked (2, ...) gradients of a small tree: bf16 and fp32
    leaves, a ragged (3,) leaf, and blocks whose (4,) leaf is ragged a
    layer and 8 stacked."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, dtype=torch.float32):
        return torch.randn((PODS, *shape), generator=g).to(dtype)

    return {"w": r(16, 8, dtype=torch.bfloat16), "bias": r(3),
            "blocks": [{"x": r(4), "w": r(8, 8, dtype=torch.bfloat16)}
                       for _ in range(2)],
            "norm": r(24)}


def _row(tree, p):
    return TSGD.tree_map(lambda _, x: x[p:p + 1].clone(), tree)


def _sync_rounds(estimator, group=None, rank=None):
    """(means a round, residual after each round) of ``ROUNDS`` syncs, the
    one-tensor form, or rank ``rank``'s process form."""
    cfg = C.GradCompressConfig(estimator=estimator)
    err = torch.randn((PODS, C.plan_for(_row(_tree_grads(0), 0), 8, 8)
                       .width), generator=torch.Generator().manual_seed(9))
    if group is not None:
        err = err[rank:rank + 1].clone()
    means, errs = [], []
    for s in range(ROUNDS):
        grads = _tree_grads(s)
        if group is not None:
            grads = _row(grads, rank)
        mean, err = C.cross_pod_sync(grads, err, cfg, step=s, group=group)
        means.append(TSGD.tree_leaves(mean))
        errs.append(err.clone())
    return means, errs


def _step_fn(arch, estimator, mesh=None):
    """The one-process step of both pods, or this rank's ``StepBundle``
    on ``mesh``."""
    cfg, gc = get_arch(arch).smoke, C.GradCompressConfig(estimator=estimator)
    if mesh is not None:
        return TST.build_lm_train(cfg, mesh, SP, OPT, compress=True,
                                  grad_sync=gc)
    return functools.partial(TST.lm_train_step, cfg=cfg, sp_cfg=SP,
                             opt_cfg=OPT, compress=True, n_pods=PODS,
                             grad_sync=gc)


def _init(arch, step):
    cfg = get_arch(arch).smoke
    if isinstance(step, TST.StepBundle):
        return step.init_state(cfg, SP, seed=0, device="cpu", compress=True)
    return TST.init_train_state(cfg, SP, seed=0, device="cpu",
                                compress=True, n_pods=PODS)


def _stream(arch, mesh):
    return lm_stream(get_arch(arch).smoke.vocab, BATCH, SEQ, device="cpu",
                     rows=None if mesh is None else (mesh.rank, PODS))


def _train(arch, estimator, mesh=None):
    step = _step_fn(arch, estimator, mesh)
    state, hist = TTR.train_steps(step, _init(arch, step),
                                  _stream(arch, mesh), STEPS)
    return state, [{k: h[k] for k in ("loss", "aux", "total")}
                   for h in hist]


def _flat(state):
    out = []
    for leaf in TSGD.tree_leaves({k: state[k] for k in
                                  ("master", "momentum", "compute")}):
        if isinstance(leaf, TO.PregenOp):
            out += [getattr(leaf, f) for f in ("bp", "vals", "idx", "mask")]
        else:
            out.append(leaf)
    return out


def _fit(bundle, state, total, ckpt_dir, mesh):
    tcfg = TTR.TrainerConfig(total_steps=total, ckpt_every=2, log_every=1,
                             ckpt_dir=str(ckpt_dir))
    return TTR.fit(bundle, state, _stream("qwen3-8b", mesh), tcfg,
                   log_fn=lambda *_: None)


def _worker(rank, store, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=PODS)
    group = dist.group.WORLD
    out = {}
    for est in ("topk", "mvue"):
        C.reset_hop_stats()
        out[f"sync_{est}"] = _sync_rounds(est, group, rank)
        out[f"hop_{est}"] = dict(C.hop_stats)
    mesh = make_host_mesh(pods=PODS)
    for name, (arch, est) in RUNS.items():
        state, hist = _train(arch, est, mesh)
        out[name] = (_flat(state), state["err"], hist)
    bundle = _step_fn("qwen3-8b", "topk", mesh)
    whole, _ = _fit(bundle, _init("qwen3-8b", bundle), 4,
                    os.path.join(out_dir, "whole"), mesh)
    _fit(bundle, _init("qwen3-8b", bundle), 2, os.path.join(out_dir, "cut"),
         mesh)
    mgr = CheckpointManager(os.path.join(out_dir, "cut"),
                            shardings=bundle.state_shardings)
    restored, step = TF.recover_or_init(
        mgr, lambda: _init("qwen3-8b", bundle), device="cpu")
    resumed, rhist = _fit(bundle, restored, 4, os.path.join(out_dir, "cut"),
                          mesh)
    out["fit"] = (step, [h["step"] for h in rhist], _flat(whole),
                  whole["err"], _flat(resumed), resumed["err"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    mp.spawn(_worker, args=(str(d / "store"), str(d)), nprocs=PODS)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(PODS)]


def _equal(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("estimator", ["topk", "mvue"])
def test_sync_bitwise_the_one_tensor_form(ranks, estimator):
    means, errs = _sync_rounds(estimator)
    for r, got in enumerate(ranks):
        g_means, g_errs = got[f"sync_{estimator}"]
        for s in range(ROUNDS):
            assert all(_equal(a, b) for a, b in zip(means[s], g_means[s]))
            assert _equal(errs[s][r:r + 1], g_errs[s])
    if estimator == "topk":
        assert not torch.equal(errs[0], errs[1])
    else:   # mvue keeps no residual
        assert torch.equal(errs[0], errs[-1])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_three_steps_bitwise_the_one_tensor_form(ranks, name):
    arch, est = RUNS[name]
    state, hist = _train(arch, est)
    for r, got in enumerate(ranks):
        flat, err, g_hist = got[name]
        assert all(_equal(a, b) for a, b in zip(_flat(state), flat))
        assert _equal(state["err"][r:r + 1], err)
        for h, g in zip(hist, g_hist):
            assert all(_equal(h[k], g[k]) for k in h)
    if arch.startswith("granite"):
        assert float(hist[0]["aux"]) > 0


def test_resumed_fit_bitwise_the_uninterrupted_one(ranks):
    for r, got in enumerate(ranks):
        step, steps, whole, whole_err, resumed, resumed_err = got["fit"]
        assert step == 2 and steps == [2, 3]
        assert all(_equal(a, b) for a, b in zip(whole, resumed))
        assert _equal(whole_err, resumed_err)
        assert float(resumed_err.abs().sum()) > 0
    assert not torch.equal(ranks[0]["fit"][3], ranks[1]["fit"][3])


def test_hop_carries_wire_bytes(ranks):
    tree = _row(_tree_grads(0), 0)
    plan = C.plan_for(tree, 8, 8)
    leaves = TSGD.tree_leaves(tree)
    total = sum(numel for _, _, numel in plan.units)
    ragged = sum(x.numel() for x, off in zip(leaves, plan.offsets)
                 if off is None)
    want = C.wire_bytes(total, ragged, C.GradCompressConfig())
    for got in ranks:
        for est in ("topk", "mvue"):
            hop = got[f"hop_{est}"]
            assert hop["backend"] == "gloo"
            assert hop["bytes_sent"] == ROUNDS * want
            assert hop["bytes_received"] == PODS * ROUNDS * want
            assert hop["gathers"] == ROUNDS * (2 * len(plan.units) + 1)
