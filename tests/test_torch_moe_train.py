"""Port parity of granite-moe-1b-a400m at SMOKE size (2 layers, d 64, 8
experts of width 32, top 2, a tied head) against the JAX reference, on
the CPU: the forward and its aux loss, BDWP 2:8 training on both
dataflows (pre-generated and packed, and the legacy ``pregen=False``
step), and serving (prefill and decode, and the packed engines' greedy
streams with a request joining mid-flight).

The reference's params and train states are loaded into the port with
``convert``; the same numpy-seeded batches feed both.  The reference's
steps are jitted; its train step is built on a mesh of ``AxisType.Auto``
axes (ROADMAP queue 3), its update on its jnp path (``use_pallas=
False``, pinned bitwise to its Pallas path by its own tests).

Tolerances (as ``test_torch_archs.py``): logits within ``ATOL`` = 4e-2.
The port's bf16 activations land one ulp away from the compiled
reference's now and then (the fp32 matmul sums run in other orders;
measured: one logit of 32768 at 2.16e-2), and routing amplifies such
flips: the reference's own logits move by 2.5e-2 to 3.6e-2 when one
element of layer 1's ln1 scale moves by one bf16 ulp, and by 0.46 to
0.77 for layer 0's (a token changes experts).  The aux loss within
1e-4 relative (layer 1's router reads those activations; measured
1.3e-5); the loss, aux and total of three steps within ``LOSS_ATOL`` =
(1e-3, 1e-3, 3e-2) (lr is 0 at step 0; step 2 carries the gradients'
ulp differences through an update at lr 0.05; aux measured 2.9e-5,
3.3e-5, 4.4e-3); the engines' streams equal.
"""

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
from repro.train import step as JST
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.models import transformer_lm as TT
from repro_torch.optim import sgd as TSGD
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR
from torch_sync_helpers import check_pod_split_metrics

jax.config.update("jax_platform_name", "cpu")

ARCH = "granite-moe-1b-a400m"
J_CFG, T_CFG = j_get_arch(ARCH).smoke, get_arch(ARCH).smoke
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
J_OPT = JSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
T_OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
ATOL = 4e-2
LOSS_ATOL = (1e-3, 1e-3, 3e-2)
BATCH, SEQ = 2, 32
DECODE_STEPS = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jparams():
    p, _ = JT.init(jax.random.PRNGKey(0), J_CFG)
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


def _tparams():
    return convert.params_from_jax(_np(_jparams()), device="cpu")


def test_forward_logits_and_aux_match_reference():
    jb = next(JD.lm_stream(J_CFG.vocab, BATCH, SEQ))[1]
    tb = next(lm_stream(T_CFG.vocab, BATCH, SEQ, device="cpu"))[1]

    @jax.jit
    def ref(p, tokens):
        hidden, _, aux = JT.forward(p, tokens, J_CFG, J_SP)
        return JT.logits_from_hidden(p, hidden, J_CFG), aux

    jlogits, jaux = ref(_jparams(), jb["tokens"])
    tp = _tparams()
    assert tp["blocks"][0]["moe"]["w_gate"].shape == (8, 64, 32)
    hidden, cache, aux = TT.forward(tp, tb["tokens"], T_CFG, T_SP)
    assert cache is None and aux.dtype == torch.float32
    logits = TT.logits_from_hidden(tp, hidden, T_CFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)


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
    """Three BDWP steps from the reference's state: loss, aux and total
    (loss + 0.01 aux, whose gradient trains the router)."""
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
    assert np.all(np.abs(port["loss"] - ref["loss"])
                  <= np.array(LOSS_ATOL)), (port, ref)
    assert np.all(np.abs(port["aux"] - ref["aux"])
                  <= np.array(LOSS_ATOL)), (port, ref)
    assert np.all(np.abs(port["total"] - ref["total"])
                  <= np.array(LOSS_ATOL)), (port, ref)
    np.testing.assert_allclose(port["total"], port["loss"]
                               + TST.AUX_COEF * port["aux"], rtol=1e-6)


def test_compressed_step_takes_each_pods_aux_on_its_rows():
    """Two pods on one device: each pod's loss and MoE aux on its own
    rows, the step's the mean (the reference's vmap over pods)."""
    m = check_pod_split_metrics(T_CFG, T_SP, T_OPT, BATCH, SEQ)
    assert float(m["aux"]) > 0


def test_prefill_and_decode_match_reference():
    """Packed u4 attention, masked experts (as the reference's element
    pack leaves them): prefill of two right-padded prompts, then
    teacher-forced per-slot decode steps."""
    from repro.serve.packed_params import pack_tree_element as j_pack
    from repro_torch.serve.packed_params import pack_tree_element

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
    jc = JT.init_lm_cache(J_CFG, 2, max_len)
    jc = jax.tree.map(lambda d, s: d.at[tuple(
        slice(0, n) for n in s.shape)].set(s.astype(d.dtype))
        if d.ndim and d.shape != s.shape else s.astype(d.dtype), jc, cj)
    tc = TT.init_lm_cache(T_CFG, 2, max_len, device="cpu")
    for dst, src in zip(tc["layers"], ct["layers"]):
        for key in ("k", "v"):
            dst[key][:, :src[key].shape[1]] = src[key]
        dst["pos"] = src["pos"]
    j_decode = jax.jit(lambda p, c, t, pos: JST.lm_decode_step(
        p, c, t, pos, cfg=J_CFG, sp_cfg=J_SP, per_slot=True))
    pos = last + 1
    for step in range(DECODE_STEPS):
        tok = np.argmax(np.asarray(lj)[:, -1, :J_CFG.vocab], -1)[:, None]
        lj, jc = j_decode(jp, jc, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32))
        lt, tc = TST.lm_decode_step(tp, tc, torch.from_numpy(tok),
                                    torch.as_tensor(pos), cfg=T_CFG,
                                    sp_cfg=T_SP)
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
    joining mid-flight; the byte reports too (experts counted as the
    reference's unpacked leaves)."""
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
    # a batched stream equals its solo stream
    teng.reset()
    solo = teng.submit(prompts[1], max_new_tokens=new[1])
    assert teng.run()[solo] == want[1]


def test_checkpoint_round_trip(tmp_path):
    """A granite train state (expert stacks and their packed (E, Kc, F)
    operands), restored, equals the saved one bitwise and trains on to
    the same loss."""
    from repro_torch.core.operand import PregenOp
    from repro_torch.train.checkpoint import CheckpointManager

    state = TST.init_train_state(T_CFG, T_SP, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    back = mgr.restore(state, device="cpu")
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
