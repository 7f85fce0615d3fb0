"""Port parity of deepseek-v2-lite-16b at SMOKE size (3 layers: a dense
prelude of FFN width 128 and 2 MoE blocks of 8 experts of width 32,
top 2, 2 shared experts; MLA with kv_lora 32; a tied head) against the
JAX reference, on the CPU: the registry and configs, the forward and
its aux loss, BDWP 2:8 training on both dataflows (pre-generated and
packed, and the legacy ``pregen=False`` step), the element pack's site
set, serving (prefill and decode per slot and with the shared cursor,
and the packed engines' greedy streams) and checkpoints.

The reference's params and train states are loaded into the port with
``convert`` (the prelude is an unstacked subtree beside the stacked
blocks); the same numpy-seeded batches feed both.  The reference's
steps are jitted, its train step built on a mesh of ``AxisType.Auto``
axes (ROADMAP queue 3), its update on its jnp path (``use_pallas=
False``, pinned bitwise to its Pallas path by its own tests).

Held bitwise: the step-0 compute tree (every MLA projection, the
prelude's FFN, the shared experts and the expert stacks pre-generated;
``ckv_norm`` and the router not); the update given the same gradients
is held in ``test_torch_deepseek_update.py``.  Tolerances are granite's
(``test_torch_moe_train.py``): logits within ``ATOL`` = 4e-2, since
routing amplifies the ulp flips of bf16 activations whose fp32 sums run
in other orders; the aux loss within 1e-4 relative; the loss, aux and
total of three steps within ``LOSS_ATOL`` = (1e-3, 1e-3, 3e-2); the
engines' streams and byte reports equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as j_get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data import synthetic as JD
from repro.models import transformer_lm as JT
from repro.optim import sgd as JSGD
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.packed_params import pack_tree_element as j_pack
from repro.train import step as JST
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import deepseek_v2_lite as TD
from repro_torch.core.operand import PackedOp, PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.models import transformer_lm as TT
from repro_torch.optim import sgd as TSGD
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.packed_params import pack_tree_element
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR
from torch_sync_helpers import check_pod_split_metrics

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v2-lite-16b"
J_CFG, T_CFG = j_get_arch(ARCH).smoke, get_arch(ARCH).smoke
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
J_OPT = JSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
T_OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
ATOL = 4e-2
LOSS_ATOL = (1e-3, 1e-3, 3e-2)
BATCH, SEQ = 2, 32
DECODE_STEPS = 8
CFG_FIELDS = ("name", "vocab", "d_model", "n_layers", "n_heads", "n_kv",
              "head_dim", "d_ff", "rope_theta", "qk_norm", "qkv_bias",
              "pattern", "window", "tie_embed", "pad_vocab_to",
              "padded_vocab", "remat", "first_dense_ff", "kv_lora",
              "qk_nope_dim", "qk_rope_dim", "v_head_dim",
              "uses_scan_prelude")
MOE_FIELDS = ("n_experts", "top_k", "d_expert", "n_shared",
              "capacity_factor", "group_size")
ATTN_SITES = ("q_proj", "kv_down", "k_up", "v_up", "o_proj")


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
def _jparams():
    p, _ = JT.init(jax.random.PRNGKey(0), J_CFG)
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


def _tparams():
    return convert.params_from_jax(_np(_jparams()), device="cpu")


# -- the registry and the configs ------------------------------------------


def test_registry_returns_the_arch_spec_and_configs_match_reference():
    j, t = j_get_arch(ARCH), get_arch(ARCH)
    assert ARCHS[ARCH] is t is TD.ARCH
    for field in ("arch_id", "family", "kind", "source", "sub_quadratic",
                  "prefix_len"):
        assert getattr(t, field) == getattr(j, field), field
    for jc, tc in ((j.full, t.full), (j.smoke, t.smoke)):
        for field in CFG_FIELDS:
            assert getattr(tc, field) == getattr(jc, field), (jc.name, field)
        for field in MOE_FIELDS:
            assert getattr(tc.moe, field) == getattr(jc.moe, field), field
        assert tc.layer_kinds() == jc.layer_kinds()
    # TRAIN: the prelude and 5 MoE layers, every published width
    assert TD.TRAIN == dataclasses.replace(t.full, n_layers=6)
    assert TD.TRAIN.n_blocks == 5 and TD.TRAIN.uses_scan_prelude


def test_converted_tree_has_the_prelude_beside_the_blocks():
    tp = _tparams()
    assert sorted(tp) == ["blocks", "embed", "final_norm", "prelude"]
    assert len(tp["blocks"]) == T_CFG.n_layers - 1
    pre, blk = tp["prelude"], tp["blocks"][0]
    assert sorted(pre) == ["attn", "ffn", "ln1", "ln2"]
    assert tuple(pre["ffn"]["w_down"]["w"].shape) == (128, 64)
    assert sorted(blk["attn"]) == sorted(ATTN_SITES + ("ckv_norm",))
    assert tuple(blk["moe"]["shared"]["w_gate"].shape) == (64, 2 * 32)
    assert tuple(blk["moe"]["w_down"].shape) == (8, 32, 64)
    # the port's own init draws the same leaves
    def shapes(tree):
        out = []
        TSGD.tree_map(lambda n, x: out.append((n, tuple(x.shape))), tree)
        return sorted(out)

    assert shapes(TT.init(T_CFG, device="cpu")) == shapes(tp)


# -- the forward ------------------------------------------------------------


def test_forward_logits_and_aux_match_reference():
    jb = next(JD.lm_stream(J_CFG.vocab, BATCH, SEQ))[1]
    tb = next(lm_stream(T_CFG.vocab, BATCH, SEQ, device="cpu"))[1]

    @jax.jit
    def ref(p, tokens):
        hidden, _, aux = JT.forward(p, tokens, J_CFG, J_SP)
        return JT.logits_from_hidden(p, hidden, J_CFG), aux

    jlogits, jaux = ref(_jparams(), jb["tokens"])
    hidden, cache, aux = TT.forward(_tparams(), tb["tokens"], T_CFG, T_SP)
    assert cache is None and aux.dtype == torch.float32
    logits = TT.logits_from_hidden(_tparams(), hidden, T_CFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)


# -- training ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jmaster():
    return jax.jit(lambda k: JST.init_train_state(
        k, J_CFG, sp_cfg=J_SP, pregen=False))(jax.random.PRNGKey(0))["master"]


def test_step0_compute_tree_bitwise_and_its_sites():
    """Every MLA projection (q_proj, kv_down, k_up, v_up, o_proj), the
    prelude's FFN, the shared experts and the expert stacks are
    pre-generated (packed) operands; ckv_norm and the router are not."""
    jcomp = jax.jit(lambda m: JSGD.pregen_tree(m, J_SP, pack=True))(
        _jmaster())
    comp = TSGD.pregen_tree(convert.params_from_jax(_np(_jmaster()),
                                                    device="cpu"),
                            T_SP, pack=True)
    _assert_tree_bitwise(jcomp, comp)
    pre, blk = comp["prelude"], comp["blocks"][0]
    for tree in (pre, blk):
        for name in ATTN_SITES:
            assert isinstance(tree["attn"][name]["w"], PregenOp), name
        assert not isinstance(tree["attn"]["ckv_norm"]["norm_scale"],
                              PregenOp)
    for name in ("w_gate", "w_up", "w_down"):
        assert isinstance(pre["ffn"][name]["w"], PregenOp)
        assert isinstance(blk["moe"][name], PregenOp)
        assert isinstance(blk["moe"]["shared"][name], PregenOp)
        assert blk["moe"][name].is_packed
    assert not isinstance(blk["moe"]["router"]["w"], PregenOp)
    sites = [t for t in TSGD.tree_leaves(comp) if isinstance(t, PregenOp)]
    assert len(sites) == 8 + 11 * (T_CFG.n_layers - 1)


def _j_run(pregen):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    bundle = JST.build_lm_train(J_CFG, mesh, J_SP, J_OPT, donate=False,
                                pregen=pregen, pregen_pack=pregen,
                                use_pallas=False)
    jstate = JST.init_train_state(jax.random.PRNGKey(0), J_CFG, sp_cfg=J_SP,
                                  pregen=pregen, pregen_pack=pregen)
    _, hist = JTR.train_steps(bundle, jstate, JD.lm_stream(
        J_CFG.vocab, BATCH, SEQ), 3)
    return jstate, {k: np.array([float(h[k]) for h in hist])
                    for k in ("loss", "aux", "total")}


@pytest.mark.parametrize("pregen", [True, False], ids=["pregen_packed",
                                                       "legacy"])
def test_three_steps_match_reference(pregen):
    """Three BDWP steps from the reference's state: loss, aux and
    total."""
    jstate, ref = _j_run(pregen)
    state = convert.train_state_from_jax(_np(jstate), device="cpu", m=8)
    assert ("compute" in state) == pregen
    fn = functools.partial(TST.lm_train_step, cfg=T_CFG, sp_cfg=T_SP,
                           opt_cfg=T_OPT, pregen=pregen, pregen_pack=pregen)
    _, thist = TTR.train_steps(fn, state, lm_stream(
        T_CFG.vocab, BATCH, SEQ, device="cpu"), 3)
    port = {k: np.array([float(h[k]) for h in thist])
            for k in ("loss", "aux", "total")}
    assert all(np.all(np.isfinite(v)) for v in port.values())
    for key in ("loss", "aux", "total"):
        assert np.all(np.abs(port[key] - ref[key])
                      <= np.array(LOSS_ATOL)), (key, port, ref)


def test_compressed_step_takes_each_pods_aux_on_its_rows():
    """Two pods on one device: each pod's loss and MoE aux on its own
    rows, the step's the mean (the reference's vmap over pods)."""
    m = check_pod_split_metrics(T_CFG, T_SP, T_OPT, BATCH, SEQ)
    assert float(m["aux"]) > 0


# -- serving ----------------------------------------------------------------


def test_element_pack_site_set_matches_reference():
    """The prelude's q_proj, kv_down, o_proj and FFN and every block's
    q_proj, kv_down and o_proj are packed (u4); k_up/v_up (read raw by
    the absorbed decode), the expert stacks and the shared experts stay
    bf16, as the reference's element pack leaves them; the stats are the
    reference's."""
    _, jstats = j_pack(_jparams(), J_SP, idx_bits=4)
    packed, stats = pack_tree_element(_tparams(), T_SP, idx_bits=4,
                                      device="cpu")
    assert stats == jstats
    packed_names = {"prelude/" + n for n in (
        "attn/q_proj", "attn/kv_down", "attn/o_proj", "ffn/w_gate",
        "ffn/w_up", "ffn/w_down")} | {"blocks/attn/" + n for n in (
            "q_proj", "kv_down", "o_proj")}
    assert stats["n_packed"] == len(packed_names) == 9
    for tree, prefix in [(packed["prelude"], "prelude")] + [
            (b, "blocks") for b in packed["blocks"]]:
        for part in ("attn", "ffn"):
            for name, leaf in tree.get(part, {}).items():
                if "w" in leaf:
                    want = f"{prefix}/{part}/{name}" in packed_names
                    assert isinstance(leaf["w"], PackedOp) == want, name
    blk = packed["blocks"][0]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        assert blk[name].dtype == blk["shared"][name].dtype == torch.bfloat16


def _j_seat(dst, src):
    if dst.ndim == 0 or dst.shape == src.shape:
        return src.astype(dst.dtype)
    return dst.at[tuple(slice(0, d) for d in src.shape)].set(
        src.astype(dst.dtype))


def _t_grow(cache, max_len):
    out = TT.init_lm_cache(T_CFG, BATCH, max_len, device="cpu")
    for dst, src in list(zip(out["layers"], cache["layers"])) + [
            (out["prelude"], cache["prelude"])]:
        for key in ("ckv", "kpe"):
            dst[key][:, :src[key].shape[1]] = src[key]
        dst["pos"] = src["pos"]
    return out


@pytest.mark.parametrize("mode", ["per_slot", "shared_cursor"])
def test_prefill_and_decode_match_reference(mode):
    """u4-packed weights (experts masked on every call, k_up/v_up raw in
    decode): prefill of two right-padded prompts, then teacher-forced
    decode steps."""
    jp, _ = j_pack(_jparams(), J_SP, idx_bits=4)
    tp, _ = pack_tree_element(_tparams(), T_SP, idx_bits=4, device="cpu")
    rng = np.random.default_rng(7)
    lens = (9, 12)
    toks = np.zeros((2, 12), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, J_CFG.vocab, n)
    last = np.asarray(lens) - 1
    max_len = 12 + DECODE_STEPS + 1
    lj, cj = jax.jit(lambda p, t, li: JST.lm_prefill_step(
        p, {"tokens": t}, cfg=J_CFG, sp_cfg=J_SP, last_index=li))(
        jp, jnp.asarray(toks), jnp.asarray(last))
    lt, ct = TST.lm_prefill_step(tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))}, cfg=T_CFG, sp_cfg=T_SP, last_index=last)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    cj = jax.tree.map(_j_seat, JT.init_lm_cache(J_CFG, 2, max_len), cj)
    ct = _t_grow(ct, max_len)
    per_slot = mode == "per_slot"
    j_decode = jax.jit(lambda p, c, t, pos: JST.lm_decode_step(
        p, c, t, pos, cfg=J_CFG, sp_cfg=J_SP, per_slot=per_slot))
    pos = last + 1 if per_slot else np.int32(12)
    for step in range(DECODE_STEPS):
        tok = np.argmax(np.asarray(lj)[:, -1, :J_CFG.vocab], -1)[:, None]
        lj, cj = j_decode(jp, cj, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32))
        lt, ct = TST.lm_decode_step(tp, ct, torch.from_numpy(tok),
                                    torch.as_tensor(pos), cfg=T_CFG,
                                    sp_cfg=T_SP, per_slot=per_slot)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        pos = pos + 1


def _mixed_run(engine, prompts, new):
    """r0, r1 start together; r2 joins when r0's slot frees."""
    r0 = engine.submit(prompts[0], max_new_tokens=new[0])
    r1 = engine.submit(prompts[1], max_new_tokens=new[1])
    r2 = None
    while engine.n_running or engine.n_queued or r2 is None:
        events = engine.step()
        if r2 is None and r0 in events["finished"]:
            r2 = engine.submit(prompts[2], max_new_tokens=new[2])
    out = engine.harvest()
    return [out[r0], out[r1], out[r2]]


def test_engine_streams_match_reference():
    """The packed (u4) engines' greedy streams are equal, a request
    joining mid-flight (its prefill seats an MLA cache with a prelude),
    and so are the byte reports; a batched stream equals its solo
    stream (decode routes the 2 slots in one group: capacity 2 = t)."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, J_CFG.vocab, n).astype(np.int32)
               for n in (4, 12, 8)]
    new = (6, 12, 8)
    kw = dict(n_slots=2, max_len=32, prompt_bucket=12, packed=True,
              idx_bits=4)
    jeng = JServeEngine(_jparams(), J_CFG, J_SP, JServeConfig(**kw))
    teng = ServeEngine(_tparams(), T_CFG, T_SP, ServeConfig(**kw),
                       device="cpu")
    want = _mixed_run(jeng, prompts, new)
    assert _mixed_run(teng, prompts, new) == want
    assert teng.hbm_report() == jeng.hbm_report()
    teng.reset()
    solo = teng.submit(prompts[1], max_new_tokens=new[1])
    assert teng.run()[solo] == want[1]


def test_checkpoint_round_trip(tmp_path):
    """A deepseek train state (the prelude's operands beside the blocks',
    MLA sites, shared experts, expert stacks), restored, equals the saved
    one bitwise and trains on to the same loss."""
    from repro_torch.train.checkpoint import CheckpointManager

    state = TST.init_train_state(T_CFG, T_SP, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    back = mgr.restore(state, device="cpu")
    assert isinstance(back["compute"]["prelude"]["attn"]["kv_down"]["w"],
                      PregenOp)
    for key in ("master", "momentum", "compute"):
        for a, b in zip(TSGD.tree_leaves(state[key]),
                        TSGD.tree_leaves(back[key])):
            for f in (("bp", "vals", "idx", "mask")
                      if isinstance(a, PregenOp) else (None,)):
                x, y = (a, b) if f is None else (getattr(a, f),
                                                 getattr(b, f))
                assert x.dtype == y.dtype and torch.equal(x, y), (key, f)
    _, batch = next(lm_stream(T_CFG.vocab, BATCH, SEQ, device="cpu"))
    fn = functools.partial(TST.lm_train_step, cfg=T_CFG, sp_cfg=T_SP,
                           opt_cfg=T_OPT)
    assert float(fn(state, batch)[1]["loss"]) == float(
        fn(back, batch)[1]["loss"])
