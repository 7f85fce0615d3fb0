"""The update of whisper-large-v3's SMOKE train state against the JAX
reference, on the CPU: given the same gradients (bf16; fp32 for the
reference's legacy dataflow, whose gradients are its cast's), master,
momentum and the next compute tree (legacy: the bf16 cast the next step
reads) are bitwise the reference's eager ``sgd.update(use_pallas=
False)`` on both dataflows, packed and unpacked.

The tree holds two block lists: an encoder layer's 6 sites and a
decoder layer's 10 (32 at SMOKE) take the fused path, one
``fused_update_sites`` call over all of them; the embedding table, the
learned positions (``pos_embed_enc``/``pos_embed_dec``, 2-D but
excluded by name), the LayerNorms and the FFN's biases take weight decay
and no SR-STE decay, as in the reference.  The reference runs eagerly:
compiled XLA on the CPU contracts multiply-adds into FMAs and the port
does not (``test_torch_dataflow.py``).
"""

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
from repro_torch.core import bdwp
from repro_torch.core.operand import PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import ops
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
# (pregen, pack) of each dataflow
FLOWS = {"pregen_packed": (True, True), "pregen_unpacked": (True, False),
         "legacy": (False, False)}
NO_SR_STE = ("pos_embed_enc", "pos_embed_dec", "embed/embed_table",
             "enc_blocks/ffn/w_in/b", "dec_blocks/ffn/w_out/b",
             "dec_blocks/ln3/norm_scale", "enc_norm/norm_bias")


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
def _jmaster():
    jc = j_get_arch(ARCH).smoke
    return jax.jit(lambda k: JST.init_train_state(
        k, jc, family="encdec", pregen=False))(jax.random.PRNGKey(0))["master"]


@pytest.mark.parametrize("flow", list(FLOWS))
def test_update_bitwise_with_the_same_gradients(flow, monkeypatch):
    pregen, pack = FLOWS[flow]
    rng = np.random.default_rng(11)
    jmaster = _jmaster()
    state = {"master": jmaster,
             "momentum": jax.tree.map(lambda a: jnp.asarray(
                 rng.standard_normal(a.shape) * 0.01, jnp.float32), jmaster),
             "step": jnp.int32(5)}
    if pregen:
        state["compute"] = jax.jit(lambda m: JSGD.pregen_tree(
            m, J_SP, pack=pack))(jmaster)
    g16 = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.bfloat16), jmaster)
    jgrads = g16 if pregen else jax.tree.map(
        lambda a: a.astype(jnp.float32), g16)
    opt = dict(lr=0.1, warmup_steps=100)
    jnew, jcomp = JSGD.update(JST.state_core(state), jgrads,
                              JSGD.SGDConfig(**opt), J_SP,
                              prev_compute=state.get("compute"),
                              pregen=pregen, pack=pack, use_pallas=False)
    tstate = convert.train_state_from_jax(_np(state), device="cpu", m=8)
    calls = []
    fused = ops.fused_update_sites
    monkeypatch.setattr(ops, "fused_update_sites",
                        lambda sites, *a, **k: calls.append(len(sites))
                        or fused(sites, *a, **k))
    tnew, tcomp = TSGD.update(
        TST.state_core(tstate), convert.params_from_jax(_np(g16),
                                                        device="cpu"),
        TSGD.SGDConfig(**opt), T_SP, prev_compute=tstate.get("compute"),
        pregen=pregen, pack=pack)
    # one grouped call over the 32 sites; none on the legacy dataflow
    assert calls == [32 if pregen else 0]
    _assert_tree_bitwise(jnew["master"], tnew["master"])
    _assert_tree_bitwise(jnew["momentum"], tnew["momentum"])
    if not pregen:
        assert tcomp is None
        tcomp = TST._bf16_cast(tnew["master"])
    _assert_tree_bitwise(jcomp, tcomp)
    site = tcomp["dec_blocks"][0]["xattn"]["o_proj"]["w"]
    assert isinstance(site, PregenOp) == pregen
    if pregen:
        assert site.is_packed == pack


@pytest.mark.parametrize("name", NO_SR_STE)
def test_positions_norms_and_biases_take_weight_decay_only(name):
    """No SR-STE decay and no site: the positions and the table are
    excluded by name ("embed"), the norms and biases are 1-D."""
    shape = {"pos_embed_enc": (128, 64), "pos_embed_dec": (64, 64),
             "embed/embed_table": (512, 64)}.get(name, (64,))
    assert not bdwp.decays(name, shape, T_SP)
    assert not bdwp.pregen_site(name, shape, T_SP)
