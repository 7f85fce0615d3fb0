"""Port parity for the qwen3-8b SMOKE model: prefill and per-slot decode.

The reference's ``transformer_lm.init`` params (cast to bf16, as the
serve engine runs them) are loaded into the port with
``convert.params_from_jax``; the same right-padded prompts go through the
reference's ``lm_prefill_step``/``lm_decode_step`` and the port's, for
packed (u4 and u8) and masked weights.

Tolerance: the port mirrors the reference's bf16 arithmetic op for op,
so the residual stream matches bit for bit wherever the two frameworks'
fp32 matmul sums round alike.  They sum in different orders, so now and
then a bf16 activation rounds the other way: one ulp, 2^-7 = 0.0078 at
|h| in [1, 2).  Such flips, carried through the remaining layers and
the lm_head, moved logits by at most 0.0065 on these inputs; the logits
are compared with atol = 2e-2, three times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import transformer_lm as JT
from repro.serve.packed_params import pack_tree_element as j_pack
from repro.train import step as JST
from repro_torch import convert
from repro_torch.configs import qwen3_8b as TC
from repro_torch.core.operand import PackedOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.serve.packed_params import pack_tree_element
from repro_torch.train import step as ST

jax.config.update("jax_platform_name", "cpu")

J_CFG = get_arch("qwen3-8b").smoke
T_CFG = TC.SMOKE
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
ATOL = 2e-2
BUCKET = 12
LENS = (5, 9)


@pytest.fixture(scope="module")
def jparams():
    p, _ = JT.init(jax.random.PRNGKey(0), J_CFG)
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


def _port_params(jp, mode):
    """The port's params for ``mode``: masked, or packed by the port."""
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    if mode == "masked":
        return tp
    return pack_tree_element(tp, T_SP, idx_bits=int(mode[-1]),
                             device="cpu")[0]


def _ref_params(jp, mode):
    if mode == "masked":
        return jp
    return j_pack(jp, J_SP, idx_bits=int(mode[-1]))[0]


def _prompts(seed=7):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(LENS), BUCKET), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(0, J_CFG.vocab, n)
    return toks


def test_config_copy_matches_reference():
    for cfg_t, cfg_j in ((TC.SMOKE, J_CFG), (TC.FULL, get_arch("qwen3-8b").full)):
        for field in ("vocab", "d_model", "n_layers", "n_heads", "n_kv",
                      "head_dim", "d_ff", "rope_theta", "qk_norm",
                      "pad_vocab_to", "padded_vocab"):
            assert getattr(cfg_t, field) == getattr(cfg_j, field), field
        assert cfg_j.tie_embed is False and cfg_j.qkv_bias is False


def test_convert_layout(jparams):
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    assert len(tp["blocks"]) == J_CFG.n_layers
    q = tp["blocks"][1]["attn"]["q_proj"]["w"]
    want = np.asarray(jparams["blocks"]["attn"]["q_proj"]["w"][1])
    assert q.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.view(torch.int16).numpy(),
                                  want.view(np.int16))
    # the reference's packed pairs convert to the port's PackedOp as is
    jpk = j_pack(jparams, J_SP)[0]
    tpk = convert.params_from_jax(jax.tree.map(np.asarray, jpk), device="cpu")
    op = tpk["blocks"][1]["ffn"]["w_down"]["w"]
    ref = jpk["blocks"]["ffn"]["w_down"]["w"]
    assert isinstance(op, PackedOp) and op.idx_bits == ref.idx_bits == 4
    np.testing.assert_array_equal(op.idx.numpy(), np.asarray(ref.idx[1]))
    mine = pack_tree_element(tp, T_SP, device="cpu")[0]
    np.testing.assert_array_equal(
        mine["blocks"][1]["ffn"]["w_down"]["w"].idx.numpy(), op.idx.numpy())


@pytest.mark.parametrize("mode", ["packed4", "packed8", "masked"])
def test_prefill_and_decode_logits(jparams, mode):
    jp, tp = _ref_params(jparams, mode), _port_params(jparams, mode)
    toks = _prompts()
    last = np.asarray(LENS) - 1
    lj, cj = JST.lm_prefill_step(jp, {"tokens": jnp.asarray(toks)},
                                 cfg=J_CFG, sp_cfg=J_SP,
                                 last_index=jnp.asarray(last))
    lt, ct = ST.lm_prefill_step(tp, {"tokens": torch.from_numpy(toks)},
                                cfg=T_CFG, sp_cfg=T_SP, last_index=last)
    assert tuple(lt.shape) == (len(LENS), 1, T_CFG.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    assert np.all(lt.numpy()[..., T_CFG.vocab:] == -1e30)
    np.testing.assert_array_equal(
        ct["layers"][0]["k"].float().numpy(),
        np.asarray(cj["layers"]["k"][0], np.float32))
    # two per-slot decode steps, each row at its own position
    tok = np.argmax(np.asarray(lj)[:, -1, :J_CFG.vocab], -1)
    pos = np.asarray(LENS)
    for _ in range(2):
        lj, cj = JST.lm_decode_step(jp, cj, jnp.asarray(tok[:, None], jnp.int32),
                                    jnp.asarray(pos, jnp.int32), cfg=J_CFG,
                                    sp_cfg=J_SP, per_slot=True)
        lt, ct = ST.lm_decode_step(tp, ct, torch.from_numpy(tok[:, None]),
                                   torch.from_numpy(pos), cfg=T_CFG,
                                   sp_cfg=T_SP)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(lj)[:, -1, :J_CFG.vocab], -1)
        pos = pos + 1


def test_init_is_seeded_and_layerwise():
    from repro_torch.models import transformer_lm as T

    a = T.init(T_CFG, seed=3, device="cpu", dtype=torch.bfloat16)
    b = T.init(T_CFG, seed=3, device="cpu", dtype=torch.bfloat16)
    gen = T.generator(3, "cpu")
    shell = T.init_shell(T_CFG, gen, device="cpu", dtype=torch.bfloat16)
    blocks = list(T.iter_blocks(T_CFG, gen, device="cpu",
                                dtype=torch.bfloat16))
    for x, y, z in ((a["lm_head"]["w"], b["lm_head"]["w"], shell["lm_head"]["w"]),
                    (a["blocks"][1]["ffn"]["w_up"]["w"],
                     b["blocks"][1]["ffn"]["w_up"]["w"],
                     blocks[1]["ffn"]["w_up"]["w"])):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert tuple(a["embed"]["embed_table"].shape) == (T_CFG.padded_vocab,
                                                     T_CFG.d_model)
