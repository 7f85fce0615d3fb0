"""whisper-large-v3's BDWP 2:8 training steps at SMOKE size against the
JAX reference, on the CPU: three steps on the pre-generating dataflow
(packed operands and unpacked ones), from the reference's own train
state converted with ``convert``, on the same ``encdec_stream`` batches
(2 rows of 32 frames and 16 tokens).  The legacy ``pregen=False`` steps
are in ``test_torch_encdec_legacy.py``.

The reference's step is ``build_encdec_train`` on a mesh of
``AxisType.Auto`` axes built here (its ``make_host_mesh`` fails under
the installed jax, ROADMAP queue 3), jitted, with its jnp update
(``use_pallas=False``).  Its loss is the mean of ``logz - gold`` over
every position, with no aux term and no compressed sync, as the port's
``encdec_train_step``.

Tolerances: the loss of each step within ``LOSS_ATOL`` = (5e-3, 1e-2,
3e-2) (measured up to 1.3e-3 at step 0, and 2.9e-3 at the legacy step 1:
the compiled reference keeps excess precision between its bf16 ops,
``test_torch_encdec.py``, and later steps carry the other side's
gradients' roundings); the learning rate equal.
"""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

from repro.configs import get_arch as j_get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data import synthetic as JD
from repro.optim import sgd as JSGD
from repro.train import step as JST
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.operand import PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import encdec_stream
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
J_OPT = JSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
T_OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
LOSS_ATOL = (5e-3, 1e-2, 3e-2)
BATCH, SEQ, FRAMES, STEPS = 2, 16, 32, 3
# (pregen, pregen_pack) of each dataflow
FLOWS = {"pregen_packed": (True, True), "pregen_unpacked": (True, False)}


def _cfgs():
    return j_get_arch(ARCH).smoke, get_arch(ARCH).smoke


@functools.lru_cache(maxsize=None)
def _j_run(flow):
    """The reference's state before the steps (numpy) and its three
    steps' metrics."""
    pregen, pack = FLOWS[flow]
    jc = _cfgs()[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    bundle = JST.build_encdec_train(jc, mesh, J_SP, J_OPT, donate=False,
                                    pregen=pregen, pregen_pack=pack,
                                    use_pallas=False)
    jstate = jax.jit(lambda k: JST.init_train_state(
        k, jc, family="encdec", sp_cfg=J_SP, pregen=pregen,
        pregen_pack=pack))(jax.random.PRNGKey(0))
    _, hist = JTR.train_steps(bundle, jstate, JD.encdec_stream(
        jc.vocab, BATCH, SEQ, jc.d_model, enc_frames=FRAMES), STEPS)
    return (jax.tree.map(np.asarray, jstate),
            [(float(h["loss"]), float(h["lr"])) for h in hist])


@pytest.mark.parametrize("flow", list(FLOWS))
def test_three_steps_match_reference(flow):
    """Three BDWP 2:8 steps from the reference's state: the losses and
    learning rates; the state keeps a compute tree (packed or not) on
    the pre-generating dataflow and none on the legacy one."""
    pregen, pack = FLOWS[flow]
    tc = _cfgs()[1]
    jstate, ref = _j_run(flow)
    state = convert.train_state_from_jax(jstate, device="cpu", m=8)
    assert ("compute" in state) == pregen
    fn = functools.partial(TST.encdec_train_step, cfg=tc, sp_cfg=T_SP,
                           opt_cfg=T_OPT, pregen=pregen, pregen_pack=pack)
    state, thist = TTR.train_steps(fn, state, encdec_stream(
        tc.vocab, BATCH, SEQ, tc.d_model, enc_frames=FRAMES, device="cpu"),
        STEPS)
    port = np.array([float(h["loss"]) for h in thist])
    want = np.array([loss for loss, _ in ref])
    assert np.all(np.isfinite(port))
    assert np.all(np.abs(port - want) <= np.array(LOSS_ATOL)), (port, want)
    assert [float(h["lr"]) for h in thist] == [lr for _, lr in ref]
    assert state["step"] == STEPS
    if pregen:
        site = state["compute"]["dec_blocks"][1]["xattn"]["k_proj"]["w"]
        assert isinstance(site, PregenOp) and site.is_packed == pack
    else:
        assert "compute" not in state


def test_step_consumes_its_state_and_leaves_no_grad():
    """The step updates master and momentum in place and leaves no
    ``requires_grad`` on the compute tree it read or the one it wrote."""
    tc = _cfgs()[1]
    state = TST.init_train_state(tc, T_SP, device="cpu")
    master_q = state["master"]["enc_blocks"][0]["attn"]["q_proj"]["w"]
    mom_q = state["momentum"]["enc_blocks"][0]["attn"]["q_proj"]["w"]
    old = state["compute"]
    _, batch = next(encdec_stream(tc.vocab, BATCH, SEQ, tc.d_model,
                                  enc_frames=FRAMES, device="cpu"))
    new, met = TST.encdec_train_step(state, batch, cfg=tc, sp_cfg=T_SP,
                                     opt_cfg=T_OPT)
    for key, t in (("master", master_q), ("momentum", mom_q)):
        got = new[key]["enc_blocks"][0]["attn"]["q_proj"]["w"]
        assert got.data_ptr() == t.data_ptr(), key
    assert float(mom_q.abs().sum()) > 0   # the step's gradient (lr 0)
    for tree in (old, new["compute"]):
        for leaf in TSGD.tree_leaves(tree):
            t = leaf.bp if isinstance(leaf, PregenOp) else leaf
            assert not t.requires_grad
    assert set(met) == {"loss", "lr"}
