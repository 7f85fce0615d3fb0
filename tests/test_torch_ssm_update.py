"""The update of mamba2-370m's and hymba-1.5b's SMOKE train states
against the JAX reference, on the CPU: given the same gradients (bf16;
fp32 for the reference's legacy dataflow, whose gradients are its
cast's), master, momentum and the next compute tree (legacy: the bf16
cast the next step reads) are bitwise the reference's eager
``sgd.update(use_pallas=False)`` on both dataflows.  The trees hold the
SSD block's sites (in_proj, out_proj; hymba's attention and FFN beside
them, on the fused path) and its elementwise leaves: conv_w, A_log, D,
dt_bias and the gate norm take weight decay and no SR-STE decay, as in
the reference, and so does mamba2's ln2, which no op reads (zero
gradient here, any gradient in the test).  A hymba-shaped variant with
in_proj F = 292 (not a multiple of 8, as FULL's 6482) holds in_proj as
an elementwise dense leaf.  The reference runs eagerly: compiled XLA
on the CPU contracts multiply-adds into FMAs and the port does not
(``test_torch_dataflow.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.optim import sgd as JSGD
from repro.train import step as JST
from repro_torch import convert
from repro_torch.core.operand import PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST

jax.config.update("jax_platform_name", "cpu")

J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
CASES = {"mamba2-370m": {}, "hymba-1.5b": {},
         "hymba-1.5b-in_proj292": dict(ssm_head_dim=32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _pairs(jtree, ttree, path=""):
    if isinstance(ttree, dict):
        assert sorted(ttree) == sorted(jtree), path
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(ttree, list):
        for i, t in enumerate(ttree):
            yield from _pairs(jax.tree.map(lambda a, i=i: a[i], jtree), t,
                              f"{path}[{i}]")
    else:
        yield path, jtree, ttree


def _assert_tree_bitwise(jtree, ttree):
    n = 0
    for name, j, t in _pairs(jtree, ttree):
        if isinstance(t, PregenOp):
            for f in ("bp", "ff", "vals", "idx", "mask"):
                jf, tf = getattr(j, f), getattr(t, f)
                assert (jf is None) == (tf is None), f"{name}.{f}"
                if tf is not None:
                    assert np.array_equal(_bits(jf), _bits(tf)), f"{name}.{f}"
                    n += 1
        else:
            assert np.array_equal(_bits(j), _bits(t)), name
            n += 1
    assert n > 0


@functools.lru_cache(maxsize=None)
def _jmaster(case):
    jc = dataclasses.replace(j_get_arch(case.split("-in_proj")[0]).smoke,
                             **CASES[case])
    return jax.jit(lambda k: JST.init_train_state(
        k, jc, sp_cfg=J_SP, pregen=False))(jax.random.PRNGKey(0))["master"]


@pytest.mark.parametrize("pregen", [True, False], ids=["pregen_packed",
                                                       "legacy"])
@pytest.mark.parametrize("case", list(CASES))
def test_update_bitwise_with_the_same_gradients(case, pregen):
    rng = np.random.default_rng(11)
    jmaster = _jmaster(case)
    state = {"master": jmaster,
             "momentum": jax.tree.map(lambda a: jnp.asarray(
                 rng.standard_normal(a.shape) * 0.01, jnp.float32), jmaster),
             "step": jnp.int32(5)}
    if pregen:
        state["compute"] = jax.jit(lambda m: JSGD.pregen_tree(
            m, J_SP, pack=True))(jmaster)
    g16 = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.bfloat16), jmaster)
    jgrads = g16 if pregen else jax.tree.map(
        lambda a: a.astype(jnp.float32), g16)
    opt = dict(lr=0.1, warmup_steps=100)
    jnew, jcomp = JSGD.update(JST.state_core(state), jgrads,
                              JSGD.SGDConfig(**opt), J_SP,
                              prev_compute=state.get("compute"),
                              pregen=pregen, pack=True, use_pallas=False)
    tstate = convert.train_state_from_jax(_np(state), device="cpu", m=8)
    tnew, tcomp = TSGD.update(
        TST.state_core(tstate), convert.params_from_jax(_np(g16),
                                                        device="cpu"),
        TSGD.SGDConfig(**opt), T_SP, prev_compute=tstate.get("compute"),
        pregen=pregen, pack=True)
    _assert_tree_bitwise(jnew["master"], tnew["master"])
    _assert_tree_bitwise(jnew["momentum"], tnew["momentum"])
    if not pregen:
        assert tcomp is None
        tcomp = TST._bf16_cast(tnew["master"])
    _assert_tree_bitwise(jcomp, tcomp)
    blk = tcomp["blocks"][0]["ssm"]
    assert isinstance(blk["out_proj"]["w"], PregenOp) == pregen
    assert (isinstance(blk["in_proj"]["w"], PregenOp)
            == (pregen and "in_proj292" not in case))
