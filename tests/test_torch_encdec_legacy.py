"""whisper-large-v3's legacy ``pregen=False`` BDWP 2:8 training steps at
SMOKE size against the JAX reference, on the CPU: the state keeps no
compute tree, every projection of both stacks re-derives its masks in
the op (``MaskedOp`` on the bf16 cast of the master), and the SR-STE
decay mask is re-derived from the master.  Three steps from the
reference's own state on the same ``encdec_stream`` batches, the
reference's step built on a mesh of ``AxisType.Auto`` axes and jitted,
as in ``test_torch_encdec_train.py``, whose ``LOSS_ATOL`` these losses
are held to (measured up to 2.9e-3 at step 1).
"""

import functools

import jax
import numpy as np
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as j_get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data import synthetic as JD
from repro.optim import sgd as JSGD
from repro.train import step as JST
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.operand import MaskedOp, as_operand
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


def _cfgs():
    return j_get_arch(ARCH).smoke, get_arch(ARCH).smoke


def test_three_legacy_steps_match_reference():
    jc, tc = _cfgs()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    bundle = JST.build_encdec_train(jc, mesh, J_SP, J_OPT, donate=False,
                                    pregen=False, use_pallas=False)
    jstate = jax.jit(lambda k: JST.init_train_state(
        k, jc, family="encdec", sp_cfg=J_SP, pregen=False))(
        jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         device="cpu", m=8)
    _, hist = JTR.train_steps(bundle, jstate, JD.encdec_stream(
        jc.vocab, BATCH, SEQ, jc.d_model, enc_frames=FRAMES), STEPS)
    assert "compute" not in state
    fn = functools.partial(TST.encdec_train_step, cfg=tc, sp_cfg=T_SP,
                           opt_cfg=T_OPT, pregen=False, pregen_pack=False)
    state, thist = TTR.train_steps(fn, state, encdec_stream(
        tc.vocab, BATCH, SEQ, tc.d_model, enc_frames=FRAMES, device="cpu"),
        STEPS)
    port = np.array([float(h["loss"]) for h in thist])
    want = np.array([float(h["loss"]) for h in hist])
    assert np.all(np.isfinite(port))
    assert np.all(np.abs(port - want) <= np.array(LOSS_ATOL)), (port, want)
    assert "compute" not in state and state["step"] == STEPS


def test_legacy_tree_masks_every_projection_in_the_op():
    """The legacy step's tree is the bf16 cast of the master: every
    projection of both stacks becomes a ``MaskedOp`` under its op name
    (the cross-attention's "xattn/..." too), the biases stay dense."""
    tc = _cfgs()[1]
    state = TST.init_train_state(tc, T_SP, device="cpu", pregen=False)
    tree = TST._bf16_cast(state["master"])
    blk = tree["dec_blocks"][0]
    for sub, name in (("attn", "q_proj"), ("xattn", "k_proj"),
                      ("ffn", "w_in")):
        w = blk[sub][name]["w"]
        assert w.dtype == torch.bfloat16
        op_name = f"{'mlp' if sub == 'ffn' else sub}/{name}"
        assert isinstance(as_operand(w, op_name, T_SP), MaskedOp), op_name
    assert blk["ffn"]["w_in"]["b"].dtype == torch.bfloat16
