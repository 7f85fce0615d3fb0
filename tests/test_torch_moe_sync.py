"""Port parity of the compressed cross-pod sync on the MoE archs (two
pods, topk with error feedback, BDWP 2:8 pre-generated and packed).

The reference runs in fresh processes on a forced 2-device CPU mesh of
``AxisType.Auto`` axes (``tests/jax_sync_reference.py``), both jobs at
once.

1. granite-moe-1b-a400m SMOKE: three compressed steps from the
   reference's state on the same batches; the loss, aux and total
   within ``LOSS_ATOL`` = (1e-3, 1e-3, 8e-2), ``test_torch_train_sync.
   py``'s: lr is 0 at step 0 and step 1 sees the same weights (the
   per-pod gradients part by bf16 ulps only), but top-2-of-8 compression
   is not continuous in them (a near tie between a group's 2nd and 3rd
   largest |g + err| flips which value is sent now and which waits in
   the residual), and routing amplifies an ulp of the update into
   another expert (ROADMAP queue 3).  Each pod's aux is taken on its own
   rows, as the reference's vmap does.  Its residual converts into the
   port's layout (the (E, K, F) expert stacks' layers in a row) and back
   bitwise.
2. deepseek-v2-lite-16b SMOKE with 2 layers (the prelude beside one
   MoE block; the reference's eager update costs ~16 s a layer here) at
   the sync level: given the reference's pod-stacked gradients (seeded
   random values in the compute tree's dtypes) and a nonzero residual,
   the port's ``cross_pod_sync`` + ``sgd.update`` equal the reference's
   jitted ``cross_pod_sync`` and eager ``sgd.update(use_pallas=False)``
   bitwise: mean gradients, residual, master, momentum, compute tree.
"""

import functools

import numpy as np
import pytest

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

TRAIN_ARCH, SYNC_ARCH = "granite-moe-1b-a400m", "deepseek-v2-lite-16b"
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
T_OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
PODS, BATCH, SEQ, STEPS = 2, 4, 16, 3
LOSS_ATOL = (1e-3, 1e-3, 8e-2)
WIDTH = {TRAIN_ARCH: 156992, SYNC_ARCH: 153472}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_references(tmp_path_factory, {
        "train": ["train", TRAIN_ARCH], "sync": ["sync", SYNC_ARCH, "n_layers=2"]})


def test_three_compressed_steps_match_reference(refs):
    ref = refs["train"]
    cfg = get_arch(TRAIN_ARCH).smoke
    state = convert.train_state_from_jax(ref["init"], device="cpu")
    assert state["err"].shape == (PODS, WIDTH[TRAIN_ARCH])
    fn = functools.partial(TST.lm_train_step, cfg=cfg, sp_cfg=T_SP,
                           opt_cfg=T_OPT, compress=True, n_pods=PODS)
    _, hist = TTR.train_steps(fn, state, lm_stream(cfg.vocab, BATCH, SEQ,
                                                   device="cpu"), STEPS)
    for key in ("loss", "aux", "total"):
        port = np.array([float(h[key]) for h in hist])
        want = np.array(ref["metrics"][key])
        assert np.all(np.isfinite(port))
        assert np.all(np.abs(port - want) <= np.array(LOSS_ATOL)), \
            (key, port, want)
    assert min(ref["metrics"]["aux"]) > 0


def test_err_converts_bitwise(refs):
    final = refs["train"]["final"]
    want = np.asarray(final["err"])
    assert np.abs(want).sum() > 0
    state = convert.train_state_from_jax(final, device="cpu")
    back = convert.err_to_jax(state["err"], state["master"], T_SP.m)
    assert back.dtype == np.float32 and np.array_equal(back, want)
    assert not np.array_equal(state["err"].numpy(), want)


def test_sync_and_update_bitwise_with_reference_gradients(refs):
    ref = refs["sync"]
    init = dict(ref["init"], step=np.int32(5), err=ref["err"])
    state = convert.train_state_from_jax(init, device="cpu")
    assert state["err"].shape == (PODS, WIDTH[SYNC_ARCH])
    assert "prelude" in state["master"]
    mean, err = C.cross_pod_sync(pod_stacked(ref["grads"]), state["err"],
                                 C.GradCompressConfig.from_sparsity(T_SP))
    assert_tree_bitwise(ref["mean"], mean)
    assert np.array_equal(convert.err_to_jax(err, state["master"], T_SP.m),
                          ref["new_err"])
    new, comp = TSGD.update(TST.state_core(state), mean,
                            TSGD.SGDConfig(lr=0.1, warmup_steps=100), T_SP,
                            prev_compute=state["compute"], pack=True)
    assert new["step"] == 6
    assert_tree_bitwise(ref["new"]["master"], new["master"])
    assert_tree_bitwise(ref["new"]["momentum"], new["momentum"])
    assert_tree_bitwise(ref["compute"], comp)
