"""Port parity of the compressed cross-pod sync on the SSM and hybrid
archs (two pods, BDWP 2:8 pre-generated and packed), and of the mvue
estimator's sync.

The reference runs in fresh processes on a forced 2-device CPU mesh of
``AxisType.Auto`` axes (``tests/jax_sync_reference.py``), the three jobs
at once.

1. mamba2-370m SMOKE: three compressed topk steps from the reference's
   state on the same batches, the losses within ``LOSS_ATOL`` = (1e-3,
   2e-3, 8e-2): ``test_torch_ssm_lm.py``'s first two (the SSD block's
   fp32 scan sums in other orders than compiled XLA's) and
   ``test_torch_train_sync.py``'s third (top-2-of-8 selection flips on
   near ties of |g + err| after the first update).  Its residual (the
   SSD block's conv, A_log, D and dt_bias among the compressible leaves)
   converts into the port's layout and back bitwise.
2. hymba-1.5b SMOKE with ``ssm_head_dim=32`` (four heads: A_log, D and
   dt_bias are (4,) a layer, ragged, and (2, 4) stacked, whole m-groups,
   so the reference compresses them across the two layers; FULL's (50,)
   x 32 layers are the same case) at the sync level: given the
   reference's pod-stacked gradients and a nonzero residual, the port's
   ``cross_pod_sync`` + ``sgd.update`` equal the reference's jitted
   ``cross_pod_sync`` and eager ``sgd.update(use_pallas=False)``
   bitwise, and the residual converts both ways bitwise.
3. mvue on the same tree: given the uniforms the reference draws (its
   ``fold_in`` chain rebuilt in the worker, moved into the port's
   column layout), the port's mvue ``cross_pod_sync`` equals the
   reference's bitwise, and keeps the residual as it is.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.optim import compress as C
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR
from torch_sync_helpers import (assert_tree_bitwise, pod_stacked,
                                run_references)

TRAIN_ARCH, SYNC_ARCH = "mamba2-370m", "hymba-1.5b"
SYNC_FIELDS = ["ssm_head_dim=32"]
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
T_OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
PODS, BATCH, SEQ, STEPS = 2, 4, 16, 3
LOSS_ATOL = (1e-3, 2e-3, 8e-2)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_references(tmp_path_factory, {
        "train": ["train", TRAIN_ARCH],
        "sync": ["sync", SYNC_ARCH, *SYNC_FIELDS],
        "mvue": ["syncmvue", SYNC_ARCH, *SYNC_FIELDS]})


def test_three_compressed_steps_match_reference(refs):
    ref = refs["train"]
    cfg = get_arch(TRAIN_ARCH).smoke
    state = convert.train_state_from_jax(ref["init"], device="cpu")
    assert state["err"].shape == (PODS, 88944)
    fn = functools.partial(TST.lm_train_step, cfg=cfg, sp_cfg=T_SP,
                           opt_cfg=T_OPT, compress=True, n_pods=PODS)
    _, hist = TTR.train_steps(fn, state, lm_stream(cfg.vocab, BATCH, SEQ,
                                                   device="cpu"), STEPS)
    port = np.array([float(h["loss"]) for h in hist])
    want = np.array(ref["metrics"]["loss"])
    assert np.all(np.isfinite(port))
    assert np.all(np.abs(port - want) <= np.array(LOSS_ATOL)), (port, want)


def test_err_converts_bitwise(refs):
    final = refs["train"]["final"]
    want = np.asarray(final["err"])
    assert np.abs(want).sum() > 0
    state = convert.train_state_from_jax(final, device="cpu")
    back = convert.err_to_jax(state["err"], state["master"], T_SP.m)
    assert back.dtype == np.float32 and np.array_equal(back, want)


def _sync_state(ref):
    init = dict(ref["init"], step=np.int32(5), err=ref["err"])
    return convert.train_state_from_jax(init, device="cpu")


def test_ragged_layer_leaves_form_one_stacked_unit(refs):
    state = _sync_state(refs["sync"])
    plan = C.plan_for(state["master"], 1 << 16, 8)
    names = {members: C.leaf_families(state["master"])[members[0]]
             for members, _, _ in plan.stacks}
    assert sorted(names.values()) == ["blocks/ssm/A_log", "blocks/ssm/D",
                                      "blocks/ssm/dt_bias"]
    assert all(len(m) == 2 for m in names)
    assert plan.width == state["err"].shape[1] == refs["sync"]["err"].shape[1]
    back = convert.err_to_jax(state["err"], state["master"], T_SP.m)
    assert np.array_equal(back, refs["sync"]["err"])


def test_sync_and_update_bitwise_with_reference_gradients(refs):
    ref = refs["sync"]
    state = _sync_state(ref)
    mean, err = C.cross_pod_sync(pod_stacked(ref["grads"]), state["err"],
                                 C.GradCompressConfig.from_sparsity(T_SP))
    assert_tree_bitwise(ref["mean"], mean)
    assert np.array_equal(convert.err_to_jax(err, state["master"], T_SP.m),
                          ref["new_err"])
    new, comp = TSGD.update(TST.state_core(state), mean,
                            TSGD.SGDConfig(lr=0.1, warmup_steps=100), T_SP,
                            prev_compute=state["compute"], pack=True)
    assert_tree_bitwise(ref["new"]["master"], new["master"])
    assert_tree_bitwise(ref["new"]["momentum"], new["momentum"])
    assert_tree_bitwise(ref["compute"], comp)


def test_mvue_sync_bitwise_given_reference_uniforms(refs):
    ref = refs["mvue"]
    state = _sync_state(ref)
    m = T_SP.m
    # one uniform a group, in the reference's slab order -> the port's
    per_col = np.repeat(ref["uniforms"], m, axis=1)
    uniforms = convert.err_from_jax(per_col, state["master"], m,
                                    device="cpu")[:, ::m].contiguous()
    err0 = state["err"].clone()
    cfg = C.GradCompressConfig.from_sparsity(T_SP, estimator="mvue")
    mean, err = C.cross_pod_sync(pod_stacked(ref["grads"]), state["err"],
                                 cfg, uniforms=uniforms)
    assert_tree_bitwise(ref["mean"], mean)
    assert torch.equal(err, err0)
    assert np.array_equal(np.asarray(ref["new_err"]), ref["err"])
