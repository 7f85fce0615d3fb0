"""Port parity of pre-generation and the update on MoE expert stacks,
and of their conversion, against the JAX reference, on the CPU.

The rig is the reference's own MoE A/B config (``tests/test_pregen.py``:
d_model 32, 8 experts of width 16, top 2, a shared expert, 2:4 bdwp),
two layers.  Bitwise: the pre-generated compute tree of the same master
and one ``sgd.update`` given the same gradients, against the reference's
eager update (``use_pallas=False``: compiled, XLA on the CPU contracts
multiply-adds, see ``test_torch_train.py``), for element, shared and
transposable masks, packed and not (element stacks take the fused path
on their (E*K, F) views), and on the legacy dataflow; the converted
(L, E, K, F) leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import moe as JM
from repro.models import transformer_lm as JT
from repro.optim import sgd as JSGD
from repro.train import step as JST
from repro_torch import convert
from repro_torch.core import operand as TO
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST

jax.config.update("jax_platform_name", "cpu")

RIG = dict(n_experts=8, top_k=2, d_expert=16, n_shared=1,
           capacity_factor=0.6, group_size=16)
RIG_LM = dict(name="moe-pregen-smoke", vocab=256, d_model=32, n_layers=2,
              n_heads=2, n_kv=1, head_dim=16, d_ff=0, tie_embed=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _sp(nm, method="bdwp", **kw):
    n, m = nm
    return (JSparsity(n=n, m=m, method=method, **kw),
            SparsityConfig(n=n, m=m, method=method, **kw))


def _rig_state(jsp, pregen=True, pack=True):
    cfg = JT.LMConfig(**RIG_LM, moe=JM.MoEConfig(**RIG))
    return cfg, JST.init_train_state(jax.random.PRNGKey(3), cfg, sp_cfg=jsp,
                                     pregen=pregen, pregen_pack=pack)


def _assert_tree_bitwise(jtree, ttree, path=""):
    if isinstance(ttree, dict):
        assert sorted(ttree) == sorted(jtree), path
        for k in ttree:
            _assert_tree_bitwise(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(ttree, list):
        for i, t in enumerate(ttree):
            _assert_tree_bitwise(jax.tree.map(lambda a, i=i: a[i], jtree), t,
                                 f"{path}[{i}]")
    elif isinstance(ttree, TO.PregenOp):
        for f in ("bp", "ff", "vals", "idx", "mask"):
            jf, tf = getattr(jtree, f), getattr(ttree, f)
            assert (jf is None) == (tf is None), f"{path}.{f}"
            if tf is not None:
                assert np.array_equal(_bits(jf), _bits(tf)), f"{path}.{f}"
    else:
        assert np.array_equal(_bits(jtree), _bits(ttree)), path


MASKS = {"element": {}, "shared": {"granularity": "shared", "tile": 8},
         "transposable": {"transposable": True}}


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("mask", list(MASKS))
def test_pregen_tree_and_update_bitwise(mask, pack):
    """The compute tree of the rig's master, and one update of it given
    the same gradients, bitwise the reference's eager update: the expert
    stacks (E, K, F) and the shared expert's bare mats are sites, the
    router is not; element stacks take the fused path on (E*K, F)."""
    jsp, tsp = _sp((2, 4), **MASKS[mask])
    _, jstate = _rig_state(jsp, pack=pack)
    jstate = dict(jstate, step=jnp.int32(3))
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu")
    _assert_tree_bitwise(jstate["compute"], TSGD.pregen_tree(
        tstate["master"], tsp, pack=pack))
    layer = tstate["compute"]["blocks"][0]["moe"]
    assert isinstance(layer["w_gate"], TO.PregenOp)
    assert isinstance(layer["shared"]["w_up"], TO.PregenOp)
    assert not isinstance(layer["router"]["w"], TO.PregenOp)
    assert tuple(layer["w_down"].bp.shape) == (8, 16, 32)
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), jstate["master"])
    opt = dict(lr=0.1, warmup_steps=100)
    jnew, jcomp = JSGD.update(JST.state_core(jstate), grads,
                              JSGD.SGDConfig(**opt), jsp,
                              prev_compute=jstate["compute"], pregen=True,
                              pack=pack, use_pallas=False)
    tnew, tcomp = TSGD.update(TST.state_core(tstate), convert.params_from_jax(
        _np(grads), device="cpu"), TSGD.SGDConfig(**opt), tsp,
        prev_compute=tstate["compute"], pack=pack)
    _assert_tree_bitwise(jnew["master"], tnew["master"])
    _assert_tree_bitwise(jnew["momentum"], tnew["momentum"])
    _assert_tree_bitwise(jcomp, tcomp)


def test_legacy_update_bitwise():
    """pregen=False: the decay mask of a stack re-derived per expert from
    the master (along K; the reference's axis 2 of (L, E, K, F))."""
    jsp, tsp = _sp((2, 4))
    _, jstate = _rig_state(jsp, pregen=False)
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu", m=4)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), jstate["master"])
    opt = JSGD.SGDConfig(lr=0.1, warmup_steps=100)
    jnew, _ = JSGD.update(JST.state_core(jstate), grads, opt, jsp,
                          pregen=False)
    tnew, comp = TSGD.update(TST.state_core(tstate), convert.params_from_jax(
        _np(grads), device="cpu"), TSGD.SGDConfig(lr=0.1, warmup_steps=100),
        tsp, pregen=False)
    assert comp is None
    _assert_tree_bitwise(jnew["master"], tnew["master"])
    _assert_tree_bitwise(jnew["momentum"], tnew["momentum"])


def test_convert_takes_expert_stacks_per_layer():
    jsp, _ = _sp((2, 4))
    _, jstate = _rig_state(jsp)
    assert jstate["master"]["blocks"]["moe"]["w_gate"].shape == (2, 8, 32, 16)
    t = convert.train_state_from_jax(_np(jstate), device="cpu")
    assert len(t["master"]["blocks"]) == 2
    for i in range(2):
        w = t["master"]["blocks"][i]["moe"]["w_gate"]
        assert tuple(w.shape) == (8, 32, 16)
        assert np.array_equal(w.numpy(), np.asarray(
            jstate["master"]["blocks"]["moe"]["w_gate"][i]))
        op = t["compute"]["blocks"][i]["moe"]["w_down"]
        assert tuple(op.vals.shape) == (8, 8, 32)
        assert np.array_equal(_bits(op.idx), _bits(
            jstate["compute"]["blocks"]["moe"]["w_down"].idx[i]))
