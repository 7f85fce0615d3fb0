"""Port parity: BDWP 2:8 training of the qwen3-8b SMOKE model with
pre-generated, SORE-packed FF operands.

The reference's train state (``repro.train.step.init_train_state`` with
``pregen_pack=True``) is loaded into the port with
``convert.train_state_from_jax``; the same batches (the port's copy of
the synthetic stream gives the reference's tokens exactly) go through
both.

1. The pre-generated compute tree of the same master is bitwise equal:
   masks, bp, vals, idx.
2. Each autograd Function's dx and bp gradient is allclose to the
   reference custom_vjp on the same inputs.  Both round fp32 sums to
   bf16 once; the sums run in other orders, so an output may land one
   bf16 ulp (2^-8 relative) away: the tolerance is 2^-7 of the largest
   magnitude.
3. ``sgd.update`` fed the reference's gradients reproduces the
   reference's new master, momentum and compute tree bitwise.  The
   reference update runs eagerly (``use_pallas=False``, its jnp path,
   which its own tests pin bitwise to its Pallas path under jit):
   compiled, XLA contracts ``mu*v + g`` and ``w - lr*v`` into fused
   multiply-adds on the CPU, while the port rounds every op, as the
   reference's source and the port's CUDA kernel do
   (``test_torch_fused_update.py``).  The step sits inside the warmup,
   where lr is plain fp32 arithmetic.  ``test_lr_schedule``: the warmup
   lr is bitwise the eager reference's; in the cosine phase ``torch.cos``
   and the eager ``jnp.cos`` differ by up to 13 ulps (3 of 143 steps).
   Compiled, the reference's lr moves further: XLA turns ``/ warmup``
   into a product with the reciprocal (0.07000001 for 0.07 at step 7 of
   10) and its cos differs from the eager one by up to 25 ulps.  So lr
   is within 1e-5 relative of both.
4. One step's gradients agree per leaf within 2e-2 of the leaf's
   largest |gradient|: the backward rounds bf16 cotangents at other
   places than XLA's fused backward (the expanded SiLU, the norms), so
   gradients differ by a few bf16 ulps (up to 0.99% of the largest
   observed).  The losses of a 3-step run (the reference step compiled,
   its update through the interpret-mode Pallas ``fused_update``) are
   allclose: steps 0 and 1 within 1e-3 (lr is 0 at step 0, so step 1
   sees the same weights; bf16 activations flip by an ulp now and then,
   as in ``test_torch_model.py``), step 2 within 3e-2 (the update at lr
   0.05 carries those gradient differences into the weights; the loss
   falls by 0.7 in that step, and the two runs differed by 0.0138).
5. In the port, the packed FF (through ``ops.nm_spmm``) and the
   unpacked FF give the same losses: on the CPU both are fp32 products
   of the same bf16 values, rounded once, so within 1e-6.
Shared-granularity and transposable masks and the legacy dataflow are
held in ``test_torch_dataflow.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch
from repro.core import operand as JO
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data import synthetic as JD
from repro.models import transformer_lm as JT
from repro.optim import sgd as JSGD
from repro.train import step as JST
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.configs import qwen3_8b as TC
from repro_torch.core import operand as TO
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.models import transformer_lm as TT
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR

jax.config.update("jax_platform_name", "cpu")

J_CFG = get_arch("qwen3-8b").smoke
T_CFG = TC.SMOKE
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
J_OPT = JSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
T_OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
BATCH, SEQ = 2, 16
STEPS = 3
LOSS_ATOL = (1e-3, 1e-3, 3e-2)
GRAD_RTOL = 2e-2


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jstate():
    return JST.init_train_state(jax.random.PRNGKey(0), J_CFG, sp_cfg=J_SP,
                                pregen=True, pregen_pack=True)


def _pairs(jtree, ttree, path=""):
    """(name, reference leaf of one layer, port leaf) over both trees."""
    if isinstance(ttree, dict):
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
        if isinstance(t, TO.PregenOp):
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


def test_pregen_tree_bitwise(jstate):
    master = convert.params_from_jax(_np(jstate["master"]), device="cpu")
    compute = TSGD.pregen_tree(master, T_SP, pack=True)
    _assert_tree_bitwise(jstate["compute"], compute)
    sites = [t for _, _, t in _pairs(jstate["compute"], compute)
             if isinstance(t, TO.PregenOp)]
    assert len(sites) == 7 * T_CFG.n_layers and all(
        s.is_packed and s.mask is not None for s in sites)


def _close(port, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * float(np.abs(ref).max()))


@pytest.mark.parametrize("core", ["masked", "pregen", "packed"])
def test_custom_gradients_match_reference(core):
    rng = np.random.default_rng(3)
    k, f, n, m = 64, 32, 2, 8
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    w = rng.standard_normal((k, f)).astype(np.float32) * k ** -0.5
    gy = rng.standard_normal((2, 5, f)).astype(np.float32)
    jx, jg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(gy, jnp.bfloat16)
    tx = convert.tensor_from_numpy(np.asarray(jx), "cpu").requires_grad_()
    tg = convert.tensor_from_numpy(np.asarray(jg), "cpu")
    if core == "masked":
        jw = jnp.asarray(w, jnp.bfloat16)
        y, vjp = jax.vjp(lambda a, b: JO.masked_linear(a, b, J_SP), jx, jw)
        dx, dw = vjp(jg)
        tw = convert.tensor_from_numpy(np.asarray(jw), "cpu").requires_grad_()
        ty = TO.masked_linear(tx, tw, T_SP)
        tdx, tdw = torch.autograd.grad(ty, (tx, tw), tg)
    else:
        op = JSGD._pregen_leaf(jnp.asarray(w), J_SP, pack=core == "packed")
        tw = convert.tensor_from_numpy(np.asarray(op.bp),
                                       "cpu").requires_grad_()
        if core == "pregen":
            y, vjp = jax.vjp(lambda a, b: JO.pregen_linear(a, op.ff, b),
                             jx, op.bp)
            ty = TO.pregen_linear(
                tx, convert.tensor_from_numpy(np.asarray(op.ff), "cpu"), tw)
        else:
            y, vjp = jax.vjp(lambda a, b: JO.packed_pregen_linear(
                a, op.vals, op.idx, b, n, m, False), jx, op.bp)
            ty = TO.packed_pregen_linear(
                tx, convert.tensor_from_numpy(np.asarray(op.vals), "cpu"),
                convert.tensor_from_numpy(np.asarray(op.idx), "cpu"), tw, n,
                m)
        dx, dw = vjp(jg)
        tdx, tdw = torch.autograd.grad(ty, (tx, tw), tg)
    assert tdx.dtype == torch.bfloat16 and tdw.dtype == tw.dtype
    _close(ty.detach(), y)
    _close(tdx, dx)
    _close(tdw, dw)


def _ref_grads(state, batch):
    """The reference step's gradients (pregen: differentiate the compute
    tree's float leaves, map to master shape)."""
    diff, meta = JST.split_compute(state["compute"])

    def loss_fn(d):
        comp = JST.merge_compute(d, meta)
        hidden, _, _ = JT.forward(comp, batch["tokens"], J_CFG, J_SP)
        return JT.lm_loss(comp, hidden, batch["labels"], J_CFG)

    g = jax.grad(loss_fn)(diff)
    return JSGD.pregen_grads(JST.merge_compute(g, meta))


def test_update_bitwise_with_reference_gradients(jstate):
    opt = JSGD.SGDConfig(lr=0.1, warmup_steps=100)
    state = dict(jstate, step=jnp.int32(5))
    _, batch = next(JD.lm_stream(J_CFG.vocab, BATCH, SEQ, seed=1))
    grads = jax.jit(_ref_grads)(state, batch)
    jnew, jcomp = JSGD.update(JST.state_core(state), grads, opt, J_SP,
                              prev_compute=state["compute"], pregen=True,
                              pack=True, use_pallas=False)
    tstate = convert.train_state_from_jax(_np(state), device="cpu")
    tgrads = convert.params_from_jax(_np(grads), device="cpu")
    tnew, tcomp = TSGD.update(TST.state_core(tstate), tgrads,
                              TSGD.SGDConfig(lr=0.1, warmup_steps=100), T_SP,
                              prev_compute=tstate["compute"], pack=True)
    assert tnew["step"] == 6
    _assert_tree_bitwise(jnew["master"], tnew["master"])
    _assert_tree_bitwise(jnew["momentum"], tnew["momentum"])
    _assert_tree_bitwise(jcomp, tcomp)


def test_step_gradients_match_reference(jstate):
    _, batch = next(JD.lm_stream(J_CFG.vocab, BATCH, SEQ))
    ref = jax.jit(_ref_grads)(jstate, batch)
    state = convert.train_state_from_jax(_np(jstate), device="cpu")
    roots = TSGD.diff_leaves(state["compute"])
    for r in roots:
        r.requires_grad_(True)
    tokens, labels = (torch.from_numpy(np.array(batch[k])).long()
                      for k in ("tokens", "labels"))
    hidden, _, _ = TT.forward(state["compute"], tokens, T_CFG, T_SP)
    loss = TT.lm_loss(state["compute"], hidden, labels, T_CFG)
    grads = TSGD.pregen_grads(state["compute"],
                              torch.autograd.grad(loss, roots))
    n = 0
    for name, j, t in _pairs(ref, grads):
        j = np.asarray(j, np.float32)
        assert t.dtype == torch.bfloat16, name
        err = np.abs(t.float().numpy() - j).max()
        assert err <= GRAD_RTOL * np.abs(j).max(), (name, err)
        n += 1
    assert n == len(roots)


def test_lr_schedule():
    opt_j = JSGD.SGDConfig(lr=0.1, warmup_steps=10, total_steps=1000)
    opt_t = TSGD.SGDConfig(lr=0.1, warmup_steps=10, total_steps=1000)
    steps = np.arange(0, 1001, 7)
    eager = np.array([JSGD.lr_schedule(opt_j, jnp.int32(s)) for s in steps])
    compiled = np.asarray(jax.jit(jax.vmap(
        lambda s: JSGD.lr_schedule(opt_j, s)))(steps))
    port = np.array([TSGD.lr_schedule(opt_t, int(s)).item() for s in steps],
                    np.float32)
    warm = steps < 10
    assert np.array_equal(port[warm], eager[warm])
    np.testing.assert_allclose(port, eager, rtol=1e-5, atol=0)
    np.testing.assert_allclose(port, compiled, rtol=1e-5, atol=0)


def _port_run(jstate, pack, steps):
    state = convert.train_state_from_jax(_np(jstate), device="cpu")
    if not pack:
        state["compute"] = TSGD.pregen_tree(state["master"], T_SP, pack=False)
    fn = functools.partial(TST.lm_train_step, cfg=T_CFG, sp_cfg=T_SP,
                           opt_cfg=T_OPT, pregen_pack=pack)
    _, hist = TTR.train_steps(fn, state,
                              lm_stream(T_CFG.vocab, BATCH, SEQ,
                                        device="cpu"), steps)
    return np.array([float(h["loss"]) for h in hist])


def test_three_step_losses_match_reference(jstate):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    bundle = JST.build_lm_train(J_CFG, mesh, J_SP, J_OPT, donate=False,
                                pregen=True, pregen_pack=True,
                                use_pallas=True)
    _, hist = JTR.train_steps(bundle, jstate,
                              JD.lm_stream(J_CFG.vocab, BATCH, SEQ), STEPS)
    ref = np.array([float(h["loss"]) for h in hist])
    port = _port_run(jstate, True, STEPS)
    assert np.all(np.isfinite(port))
    assert np.all(np.abs(port - ref) <= np.array(LOSS_ATOL)), (port, ref)


def test_packed_and_unpacked_ff_agree(jstate):
    packed = _port_run(jstate, True, 2)
    unpacked = _port_run(jstate, False, 2)
    np.testing.assert_allclose(packed, unpacked, rtol=0, atol=1e-6)
