"""Port parity of the MoE modules (``models/moe.py`` and what it reaches)
against the JAX reference, on the CPU.

The routing rig is the reference's own MoE A/B config
(``tests/test_pregen.py``: 8 experts, top 2, a shared expert, capacity
factor 0.6 over groups of 16, so tokens really drop; 2:4 bdwp), beside
granite's SMOKE MoE (8 experts, top 2, factor 1.25, 2:8) and
deepseek-v2-lite's (the same with 2 shared experts).

What is held bitwise: given the same fp32 probabilities, the routing
tables (top-k experts and values, each slot's token, each assignment's
slot); the compiled reference's ``moe_apply`` output and aux loss (the
combine rounds once, as the compiled reference computes it);
``pack_tree_element``'s stats; each expert of a stacked plain
``nm_spmm`` against the 2-D one.  The update of expert stacks is held in
``test_torch_moe_update.py``, whole models in ``test_torch_moe_train.py``.

Tolerances: the router probabilities within 1.2e-7 (two fp32 ulps of
a probability near 1: the logits' fp32 sums run in another order); the stacked
matmuls within 1e-5 x (|x| @ |W|) of the reference's vmapped ones (the
same exact bf16 products summed in fp32 in other orders); gradients per
leaf within 2e-2 of the leaf's largest |gradient| and forward outputs
within 2^-7 of the largest |output| (bf16 roundings of fp32 sums in
other orders, as ``test_torch_train.py``).
"""


import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import bdwp as JB
from repro.core import operand as JO
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import moe as JM
from repro.models import transformer_lm as JT
from repro.optim import sgd as JSGD
from repro.serve import packed_params as JPP
from repro.train import step as JST
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import granite_moe_1b as TG
from repro_torch.core import bdwp as TB
from repro_torch.core import operand as TO
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import nm_spmm as KS
from repro_torch.kernels import ref
from repro_torch.models import moe as TM
from repro_torch.optim import sgd as TSGD
from repro_torch.serve import packed_params as TPP

jax.config.update("jax_platform_name", "cpu")

RIG = dict(n_experts=8, top_k=2, d_expert=16, n_shared=1,
           capacity_factor=0.6, group_size=16)
GRANITE = dict(n_experts=8, top_k=2, d_expert=32)
DEEPSEEK = dict(n_experts=8, top_k=2, d_expert=32, n_shared=2)
CASES = {"drops+shared 2:4": (RIG, 32, (2, 4)),
         "granite smoke 2:8": (GRANITE, 64, (2, 8)),
         "deepseek smoke 2:8": (DEEPSEEK, 64, (2, 8))}
RIG_LM = dict(name="moe-pregen-smoke", vocab=256, d_model=32, n_layers=2,
              n_heads=2, n_kv=1, head_dim=16, d_ff=0, tie_embed=True)
GRAD_RTOL = 2e-2
OUT_RTOL = 2 ** -7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), "cpu")


def _sp(nm, method="bdwp", **kw):
    n, m = nm
    return (JSparsity(n=n, m=m, method=method, **kw),
            SparsityConfig(n=n, m=m, method=method, **kw))


def _case(name, dtype=jnp.bfloat16, seed=0):
    """(jcfg, tcfg, jsp, tsp, reference params in ``dtype``, x bf16)."""
    moe, d, nm = CASES[name]
    jsp, tsp = _sp(nm)
    jcfg, tcfg = JM.MoEConfig(**moe), TM.MoEConfig(**moe)
    p, _ = JM.moe_init(jax.random.PRNGKey(seed), d, jcfg)
    p = jax.tree.map(lambda a: a.astype(dtype), p)
    x = np.random.default_rng(seed).standard_normal((2, 32, d))
    return jcfg, tcfg, jsp, tsp, p, jnp.asarray(x, jnp.bfloat16)


def _spied_moe(cfg, sp):
    """The reference's moe_apply, also returning the index arrays of its
    two slot gathers (dispatch, combine), its softmax and its router's
    top_k (the first top_k call)."""
    def run(p, x):
        box = {"gathers": []}
        gather, softmax, top_k = JM._slot_gather, jax.nn.softmax, \
            jax.lax.top_k

        def spy_gather(src, idx):
            box["gathers"].append(idx)
            return gather(src, idx)

        def spy_softmax(z, axis=-1):
            box["probs"] = softmax(z, axis=axis)
            return box["probs"]

        def spy_top_k(a, k):
            out = top_k(a, k)
            box.setdefault("top_k", out)
            return out

        JM._slot_gather, jax.nn.softmax, jax.lax.top_k = (
            spy_gather, spy_softmax, spy_top_k)
        try:
            y, aux = JM.moe_apply(p, x, cfg, sp)
        finally:
            JM._slot_gather, jax.nn.softmax, jax.lax.top_k = (
                gather, softmax, top_k)
        return y, aux, box
    return jax.jit(run)


def _tparams(p):
    return convert.params_from_jax(_np({"moe": p}), device="cpu")["moe"]


# -- config and policy ------------------------------------------------------


def test_granite_config_matches_reference():
    j, t = j_get_arch("granite-moe-1b-a400m"), get_arch(
        "granite-moe-1b-a400m")
    for field in ("arch_id", "family", "kind", "source", "sub_quadratic",
                  "prefix_len"):
        assert getattr(t, field) == getattr(j, field), field
    for jc, tc in ((j.full, t.full), (j.smoke, t.smoke)):
        for field in ("name", "vocab", "d_model", "n_layers", "n_heads",
                      "n_kv", "head_dim", "d_ff", "rope_theta", "qk_norm",
                      "pattern", "tie_embed", "padded_vocab", "remat"):
            assert getattr(tc, field) == getattr(jc, field), field
        for field in ("n_experts", "top_k", "d_expert", "n_shared",
                      "capacity_factor", "group_size"):
            assert getattr(tc.moe, field) == getattr(jc.moe, field), field
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
    assert TG.TRAIN == t.full              # nothing cut


def test_deepseek_waits_on_item_4():
    """Item 4 is ported: the registry gives deepseek's ArchSpec, whose
    MoE (shared experts) is the "deepseek smoke" case here."""
    assert "deepseek-v2-lite-16b" in ARCHS
    moe = get_arch("deepseek-v2-lite-16b").smoke.moe
    assert dataclasses.asdict(moe) == dict(
        DEEPSEEK, capacity_factor=1.25, group_size=512)


@pytest.mark.parametrize("name,shape", [
    ("blocks/moe/w_gate", (8, 64, 32)), ("blocks/moe/w_down", (8, 32, 64)),
    ("blocks/moe/w_up", (8, 12, 32)), ("blocks/moe/shared/w_gate", (32, 16)),
    ("blocks/moe/router/w", (64, 8)), ("blocks/ffn/w_gate/w", (64, 128)),
    ("blocks/moe/w_gate", (8, 64, 4))])
@pytest.mark.parametrize("method", ["bdwp", "srste", "sdgp", "sdwp",
                                    "dense"])
def test_policy_on_expert_stacks_matches_reference(name, shape, method):
    """The per-layer (E, K, F) stack and its per-expert (K, F) slice
    get the reference's verdicts on its (E, K, F) logical shape."""
    jsp, tsp = _sp((2, 8), method)
    assert TB.bare_nm_leaf(name) == JB.bare_nm_leaf(name)
    for s in (shape, shape[1:] if len(shape) == 3 else shape):
        assert TB.should_prune(name, s, tsp) == JB.should_prune(name, s, jsp)
        assert TB.decays(name, s, tsp) == JB.decays(name, s, jsp)
        assert TB.pregen_site(name, s, tsp) == JB.pregen_site(name, s, jsp)
        assert (TB.pick_cfg(name, s, tsp).method
                == JB.pick_cfg(name, s, jsp).method)
        assert TB.ff_group_axis(s) == JB.ff_group_axis(s)
        assert TB.bp_group_axis(s) == JB.bp_group_axis(s)


# -- routing and moe_apply --------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_routing_tables_bitwise(case):
    jcfg, tcfg, jsp, tsp, p, x = _case(case)
    _, _, box = _spied_moe(jcfg, jsp)(p, x)
    tp = _tparams(p)
    g, sg = box["gathers"][0].shape[0], box["probs"].shape[1]
    xt = _t(x).reshape(g, sg, -1)
    probs = TM.router_probs(xt, tp["router"]["w"])
    jprobs = np.asarray(box["probs"])
    np.testing.assert_allclose(probs.numpy(), jprobs, atol=1.2e-7, rtol=0)
    # the rest bitwise, given the reference's probabilities
    r = TM.route(torch.from_numpy(jprobs.copy()), tcfg)
    top_v, top_i = box["top_k"]
    assert np.array_equal(r.gate_idx.numpy(), np.asarray(top_i))
    got_top = torch.gather(r.probs, -1, r.gate_idx)
    assert np.array_equal(_bits(got_top), _bits(top_v))
    assert np.array_equal(r.slot_token.numpy(), np.asarray(box["gathers"][0]))
    slot_of = r.gate_idx * r.cap + torch.where(r.keep, r.pos, 0)
    assert np.array_equal(slot_of.numpy(), np.asarray(box["gathers"][1]))
    if case.startswith("drops"):
        assert int((~r.keep).sum()) > 0      # capacity really drops


def test_route_ties_pick_the_lower_expert():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25]]] * 3).reshape(1, 3, 4)
    r = TM.route(probs, TM.MoEConfig(n_experts=4, top_k=2, d_expert=8))
    j = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    assert np.array_equal(r.gate_idx.numpy(), np.asarray(j))


@pytest.mark.parametrize("t,cf,group", [(64, 1.25, 512), (5, 1.25, 512),
                                        (48, 0.6, 16), (4, 1.25, 512),
                                        (1, 1.25, 512), (30, 1.0, 16)])
def test_capacity_and_groups_match_reference(t, cf, group):
    """Groups and capacity (Python's round, half to even) from the
    reference's slot table shape."""
    cfg = dict(n_experts=8, top_k=2, d_expert=8, capacity_factor=cf,
               group_size=group)
    jcfg, tcfg = JM.MoEConfig(**cfg), TM.MoEConfig(**cfg)
    p, _ = JM.moe_init(jax.random.PRNGKey(1), 16, jcfg)
    x = jnp.ones((1, t, 16), jnp.bfloat16)
    _, _, box = _spied_moe(jcfg, JSparsity())(p, x)
    sg = TM.group_size(t, tcfg)
    assert box["gathers"][0].shape == (t // sg, 8, TM.capacity(sg, tcfg))


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_compiled_reference(case):
    """Output and aux bitwise the compiled reference's (masked bf16
    experts, so its matmuls round as the port's)."""
    jcfg, tcfg, jsp, tsp, p, x = _case(case)
    jy, jaux, _ = _spied_moe(jcfg, jsp)(p, x)
    y, aux = TM.moe_apply(_tparams(p), _t(x), tcfg, tsp)
    assert y.dtype == torch.bfloat16 and y.shape == tuple(jy.shape)
    assert np.array_equal(_bits(y), _bits(jy))
    assert np.array_equal(_bits(aux), _bits(jaux))


def _grads_close(jg, tg, label):
    jg = np.asarray(jg, np.float32)
    tg = tg.float().numpy()
    scale = np.abs(jg).max()
    assert scale > 0, label
    np.testing.assert_allclose(tg, jg, atol=GRAD_RTOL * scale, rtol=0,
                               err_msg=label)


def _loss_and_grads(case, tree_kind):
    """The reference's and the port's (y, aux) and the gradients of
    sum(y * cot) + 0.01 aux w.r.t. x and every float leaf, with the
    experts bare bf16 weights ("masked") or the pre-generated compute
    tree of the fp32 params ("pregen", "packed")."""
    jcfg, tcfg, jsp, tsp, p, x = _case(case, dtype=jnp.float32)
    if tree_kind == "masked":
        jtree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    else:
        jtree = JSGD.pregen_tree({"moe": p}, jsp,
                                 pack=tree_kind == "packed")["moe"]
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    diff, meta = JST.split_compute({"t": jtree, "x": x})

    def jloss(d):
        tree = JST.merge_compute(d, meta)
        y, aux = JM.moe_apply(tree["t"], tree["x"], jcfg, jsp)
        return jnp.sum(y.astype(jnp.float32) * cot) + 0.01 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        diff)
    jg = JST.merge_compute(jg, meta)
    ttree = convert.params_from_jax(_np({"moe": jtree}), device="cpu")["moe"]
    tx = _t(x)
    roots = [tx] + TSGD.diff_leaves(ttree)
    for r in roots:
        r.requires_grad_(True)
    y, aux = TM.moe_apply(ttree, tx, tcfg, tsp)
    loss = (y.float() * torch.from_numpy(cot)).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, roots)
    return (jy, jaux, jg), (y.detach(), aux.detach(), grads, ttree)


@pytest.mark.parametrize("tree_kind", ["masked", "pregen", "packed"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_gradients_match_reference(case, tree_kind):
    (jy, jaux, jg), (y, aux, grads, ttree) = _loss_and_grads(case, tree_kind)
    scale = float(np.abs(np.asarray(jy, np.float32)).max())
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=OUT_RTOL * scale, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    _grads_close(jg["x"], grads[0], "x")
    jleaves = [leaf.bp if isinstance(leaf, JO.PregenOp) else leaf
               for leaf in jax.tree.leaves(
                   jg["t"], is_leaf=lambda n: isinstance(n, JO.PregenOp))
               if isinstance(leaf, JO.PregenOp)
               or jnp.issubdtype(leaf.dtype, jnp.inexact)]
    # the reference flattens dict keys sorted; the port walks them in
    # insertion order: pair the leaves by name
    names = sorted(_leaf_names(ttree))
    by_name = dict(zip(names, jleaves))
    for (name, tg) in zip(_leaf_names(ttree), grads[1:]):
        _grads_close(by_name[name], tg, name)
    if tree_kind == "packed":
        assert isinstance(ttree["w_gate"], TO.PregenOp)
        assert ttree["w_gate"].vals.ndim == 3


def _leaf_names(tree, path=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaf_names(v, f"{path}/{k}")
        elif isinstance(v, TO.PregenOp) or v.is_floating_point():
            out.append(f"{path}/{k}")
    return out


# -- the stacked operands ---------------------------------------------------

E, T, K, F = 4, 12, 32, 16


def _stack_case(seed=0):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((E, K, F)) * K ** -0.5, jnp.float32)
    x = jnp.asarray(rng.standard_normal((E, T, K)), jnp.bfloat16)
    g = rng.standard_normal((E, T, F)).astype(np.float32)
    return w, x, g


def _jop(kind, w, jsp):
    if kind == "masked":
        return JO.MaskedOp(w.astype(jnp.bfloat16), jsp)
    return JSGD._pregen_leaf(w, jsp, pack=kind.startswith("packed"))


@pytest.mark.parametrize("kind,method,extra", [
    ("masked", "bdwp", {}), ("masked", "sdgp", {}), ("masked", "srste", {}),
    ("masked", "dense", {}), ("masked", "bdwp", {"granularity": "shared",
                                                 "tile": 8}),
    ("pregen", "bdwp", {}), ("packed", "bdwp", {}), ("packed", "srste", {}),
    ("packed_t", "bdwp", {"transposable": True})])
def test_stacked_nm_apply_matches_reference(kind, method, extra):
    """Forward, dx and the weight's (``bp``'s) gradient of an (E, K, F)
    operand on (E, T, K) activations (the port's ``nm_apply`` reads the
    stack from the rank), against the reference's
    ``nm_apply(stacked=True)``."""
    jsp, tsp = _sp((2, 8), method, **extra)
    w, x, g = _stack_case()
    jop = _jop(kind, w, jsp)

    def jf(op, x):
        y = JO.nm_apply(op, x, backend="pallas", stacked=True)
        return jnp.sum(y.astype(jnp.float32) * g), y

    diff, meta = JST.split_compute({"op": jop, "x": x})
    (_, jy), jgr = jax.jit(jax.value_and_grad(
        lambda d: jf(**JST.merge_compute(d, meta)), has_aux=True))(diff)
    jgr = JST.merge_compute(jgr, meta)
    if kind == "masked":
        top = TO.MaskedOp(_t(jop.w), tsp)
    else:
        top = convert.params_from_jax(_np({"op": jop}), device="cpu")["op"]
    tx = _t(x).requires_grad_(True)
    wleaf = top.w if kind == "masked" else top.bp
    wleaf.requires_grad_(True)
    y = TO.nm_apply(top, tx)
    scale = float(np.abs(np.asarray(jy, np.float32)).max())
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(jy, np.float32),
                               atol=OUT_RTOL * scale, rtol=0)
    dx, dw = torch.autograd.grad((y.float() * torch.from_numpy(g)).sum(),
                                 [tx, wleaf])
    _grads_close(jgr["x"], dx, "dx")
    jw = jgr["op"].w if kind == "masked" else jgr["op"].bp
    _grads_close(jw, dw, "dw")


@pytest.mark.parametrize("idx_bits", [8, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_stacked_plain_spmm_matches_vmapped_reference(idx_bits, use_pallas):
    """``ops.nm_spmm`` on an (E, B, K) x (E, Kc, F) stack (the plain
    version on the CPU) against the reference's vmapped
    ``_spmm_stacked`` (its oracle, or its interpret-mode Pallas kernel);
    each expert's slab bitwise the 2-D plain call on that expert."""
    from repro.core.sparsity import nm_pack, pack_idx_u4

    rng = np.random.default_rng(idx_bits)
    e, b, k, f = 3, 8, 64, 32
    w = jnp.asarray(rng.standard_normal((e, k, f)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((e, b, k)), jnp.bfloat16)
    vals, idx = nm_pack(w, 2, 8, axis=1)
    if idx_bits == 4:
        idx = pack_idx_u4(idx, axis=1)
    want = JO._spmm_stacked(x, vals, idx, 2, 8, use_pallas, idx_bits)
    tx, tv, ti = _t(x), _t(vals), _t(idx)
    from repro_torch.kernels import ops
    got = ops.nm_spmm(tx, tv, ti, 2, 8, idx_bits)
    assert got.shape == (e, b, f) and got.dtype == torch.float32
    dense = ref.decompress_nm(tv, ti, 2, 8, axis=-2, idx_bits=idx_bits)
    scale = (tx.float().abs() @ dense.float().abs()).numpy()
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-5 * scale)
    for j in range(e):
        assert torch.equal(got[j], ref.ref_nm_spmm(tx[j], tv[j], ti[j], 2, 8,
                                                   idx_bits))


def test_stacked_plan_keeps_the_chunks():
    """The stack may change the tile and the split, never the chunks
    (what fixes a row's bits), at granite's expert shapes."""
    for b, k, f in ((1280, 1024, 512), (1280, 512, 1024), (8, 1024, 512),
                    (160, 1024, 512)):
        one, many = KS.plan(b, k, f, 2, 8), KS.plan(b, k, f, 2, 8, 32)
        assert (one.chunk_groups, one.n_chunks) == (many.chunk_groups,
                                                    many.n_chunks)
        assert many.splits <= one.splits
    assert KS.plan(1280, 1024, 512, 2, 8, 32).splits == 1


def test_stacked_kernel_wrapper_refuses_cpu_and_mismatched_stacks():
    x = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    vals = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    idx = torch.zeros((2, 4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not CUDA"):
        KS.nm_spmm(x, vals, idx, 2, 8)


# -- packing for serving ----------------------------------------------------


@pytest.mark.parametrize("idx_bits", [4, 8])
def test_pack_tree_element_stats_match_reference(idx_bits):
    """Attention projections pack; the bare expert stacks stay bf16 and
    are served through MaskedOp, as the reference's element pack leaves
    them; the stats agree."""
    jcfg = j_get_arch("granite-moe-1b-a400m").smoke
    jp, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    jsp, tsp = _sp((2, 8))
    _, jstats = JPP.pack_tree_element(jp, jsp, idx_bits=idx_bits)
    packed, tstats = TPP.pack_tree_element(
        convert.params_from_jax(_np(jp), device="cpu"), tsp,
        idx_bits=idx_bits, device="cpu")
    assert tstats == jstats
    moe = packed["blocks"][0]["moe"]
    assert isinstance(packed["blocks"][0]["attn"]["q_proj"]["w"],
                      TO.PackedOp)
    assert moe["w_gate"].dtype == torch.bfloat16 and moe["w_gate"].ndim == 3
    assert not isinstance(moe["router"]["w"], TO.PackedOp)
