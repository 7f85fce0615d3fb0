"""Serving whisper-large-v3 at SMOKE size against the JAX reference, on
the CPU: the element pack's stats and site set, packed against masked
serving, the prefill (its cache exactly as long as the prompt) and
teacher-forced decode steps on the shared cursor from a seated cache,
the reference's hazards, and a checkpoint round trip.

The reference's prefill cache has no room to decode into
(``encdec_prefill_step`` allocates ``init_cache(cfg, b, s)``), so every
driver seats it in a longer one first (``_seat``), as
``tests/test_archs.py`` does for the LM.  Three reference hazards are
pinned here, in both packages (ROADMAP queue 3):
  * a decode step straight after the prefill writes at the cursor
    clamped to s - 1, over the last prompt token's K/V;
  * the decoder's self-attention applies RoPE on top of the learned
    positions (the module docstring says "no RoPE");
  * the cross-attention K/V are projected from the encoder output again
    in every layer of every decode step.

Tolerances: logits within ``ATOL`` = 4e-2 (the compiled reference's
excess precision, ``test_torch_encdec.py``; measured up to 3.1e-2 here);
the hazard's gaps within ``GAP_ATOL`` = 0.1 of the reference's (measured
0.478 / 0.481 dense and 0.407 / 0.394 bdwp, reference / port, largest
logit 3.7); the element pack's stats and the packed serving of each
package equal to its masked serving where stated.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import encdec as JE
from repro.serve.packed_params import pack_tree_element as j_pack
from repro.train import step as JST
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.operand import PackedOp, PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import encdec_stream
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.optim import sgd as TSGD
from repro_torch.serve.packed_params import (PackedParamStore,
                                             pack_tree_element)
from repro_torch.train import step as TST

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
METHODS = ("dense", "bdwp")
ATOL = 4e-2
GAP_ATOL = 0.1
BATCH, FRAMES, PROMPT, DECODE = 2, 16, 8, 12
SITES = {"enc_blocks": ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                        "attn/o_proj", "ffn/w_in", "ffn/w_out"),
         "dec_blocks": ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                        "attn/o_proj", "xattn/q_proj", "xattn/k_proj",
                        "xattn/v_proj", "xattn/o_proj", "ffn/w_in",
                        "ffn/w_out")}


def _sp(method):
    return (JSparsity(n=2, m=8, method=method),
            SparsityConfig(n=2, m=8, method=method))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs():
    return j_get_arch(ARCH).smoke, get_arch(ARCH).smoke


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _jparams():
    p, _ = JE.init(jax.random.PRNGKey(0), _cfgs()[0])
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


def _tparams():
    return convert.params_from_jax(_np(_jparams()), device="cpu")


def _inputs(seed=0, n_tok=PROMPT + 1):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(BATCH, FRAMES, 64)).astype(np.float32)
    toks = rng.integers(0, 512, size=(BATCH, n_tok)).astype(np.int32)
    return ((jnp.asarray(frames, jnp.bfloat16), jnp.asarray(toks)),
            (torch.from_numpy(frames).to(torch.bfloat16),
             torch.from_numpy(toks).long()))


@functools.lru_cache(maxsize=None)
def _jsteps(method):
    """The reference's jitted prefill and decode steps, shared by the
    tests (each compiles once per input shape)."""
    jc, jsp = _cfgs()[0], _sp(method)[0]
    pre = jax.jit(lambda p, b: JST.encdec_prefill_step(p, b, cfg=jc,
                                                       sp_cfg=jsp))
    dec = jax.jit(lambda p, c, e, t, pos: JST.encdec_decode_step(
        p, c, e, t, pos, cfg=jc, sp_cfg=jsp))
    return pre, dec


def _jseat(cache, max_len):
    """The reference's prefill cache in a ``max_len``-long one."""
    big = JE.init_cache(_cfgs()[0], cache["layers"]["k"].shape[1], max_len)
    s = cache["layers"]["k"].shape[2]
    return {"layers": {"k": big["layers"]["k"].at[:, :, :s].set(
        cache["layers"]["k"]), "v": big["layers"]["v"].at[:, :, :s].set(
        cache["layers"]["v"]), "pos": cache["layers"]["pos"]}}


def _seat(cache, max_len):
    """The port's prefill cache in a ``max_len``-long one."""
    b = cache["layers"][0]["k"].shape[0]
    big = TE.init_cache(_cfgs()[1], b, max_len, device="cpu")
    for dst, src in zip(big["layers"], cache["layers"]):
        s = src["k"].shape[1]
        dst["k"][:, :s], dst["v"][:, :s] = src["k"], src["v"]
        dst["pos"] = src["pos"]
    return big


# -- the element pack ---------------------------------------------------------


def test_element_pack_stats_and_sites_match_reference():
    """Both block lists are walked: 16 names packed (each stacked name
    once, 32 weights), none dense, the biases served dense beside their
    pairs; the byte counts are the reference's."""
    jsp, tsp = _sp("bdwp")
    _, jstats = j_pack(_jparams(), jsp, idx_bits=4)
    packed, stats = pack_tree_element(_tparams(), tsp, idx_bits=4,
                                      device="cpu")
    assert stats == jstats
    assert stats["n_packed"] == 16 and stats["n_dense"] == 0
    for stack, names in SITES.items():
        for blk in packed[stack]:
            for name in names:
                assert isinstance(_at(blk, name)["w"], PackedOp), name
            assert blk["ffn"]["w_in"]["b"].dtype == torch.bfloat16
    store = PackedParamStore.pack(_tparams(), tsp, device="cpu")
    assert store.report()["measured_over_accounted_4bit"] == 1.0


@pytest.mark.parametrize("side", ["reference", "port"])
def test_packed_serving_equals_masked(side):
    """Prefill logits from the packed tree equal the masked tree's:
    bitwise in the reference, within 1e-5 in the port (the plain packed
    product and the masked one sum the same products in other
    orders)."""
    jc, tc = _cfgs()
    jsp, tsp = _sp("bdwp")
    (jf, jt), (tf, tt) = _inputs()
    if side == "reference":
        pre, _ = _jsteps("bdwp")
        masked = pre(_jparams(), {"frames": jf, "tokens": jt})[0]
        packed = pre(j_pack(_jparams(), jsp)[0],
                     {"frames": jf, "tokens": jt})[0]
        assert np.array_equal(np.asarray(masked), np.asarray(packed))
        return
    with torch.no_grad():
        masked = TST.encdec_prefill_step(_tparams(), {"frames": tf,
                                                      "tokens": tt},
                                         cfg=tc, sp_cfg=tsp)[0]
        packed = TST.encdec_prefill_step(
            pack_tree_element(_tparams(), tsp, device="cpu")[0],
            {"frames": tf, "tokens": tt}, cfg=tc, sp_cfg=tsp)[0]
    np.testing.assert_allclose(packed.numpy(), masked.numpy(), atol=1e-5,
                               rtol=0)


# -- prefill and decode -------------------------------------------------------


def test_prefill_cache_is_the_prompts_length_and_its_logits_the_forwards():
    _, tc = _cfgs()
    _, tsp = _sp("bdwp")
    _, (tf, tt) = _inputs()
    tp = _tparams()
    with torch.no_grad():
        logits, cache, enc = TST.encdec_prefill_step(
            tp, {"frames": tf, "tokens": tt}, cfg=tc, sp_cfg=tsp)
        hidden, _ = TE.decode(tp, tt, TE.encode(tp, tf, tc, tsp), tc, tsp)
        full = TE.logits_from_hidden(tp, hidden, tc)
    assert len(cache["layers"]) == tc.n_layers
    for lc in cache["layers"]:
        assert tuple(lc["k"].shape) == (BATCH, PROMPT + 1, tc.n_kv,
                                        tc.head_dim)
        assert lc["pos"] == PROMPT + 1
    assert tuple(enc.shape) == (BATCH, FRAMES, tc.d_model)
    assert tuple(logits.shape) == (BATCH, 1, tc.padded_vocab)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("method,packed", [("dense", False),
                                           ("bdwp", False), ("bdwp", True)],
                         ids=["dense", "bdwp-masked", "bdwp-packed"])
def test_prefill_and_shared_cursor_decode_match_reference(method, packed):
    """An 8-token prefill seated in a longer cache, then DECODE decode
    steps on the shared cursor, teacher-forced by the reference's
    argmax: every step's logits."""
    jc, tc = _cfgs()
    jsp, tsp = _sp(method)
    (jf, jt), (tf, tt) = _inputs()
    jp, tp = _jparams(), _tparams()
    if packed:
        jp, tp = j_pack(jp, jsp)[0], pack_tree_element(tp, tsp,
                                                       device="cpu")[0]
    pre, dec = _jsteps(method)
    jl, jc_, je = pre(jp, {"frames": jf, "tokens": jt[:, :PROMPT]})
    jcache = _jseat(jc_, PROMPT + DECODE)
    with torch.no_grad():
        tl, tc_, te = TST.encdec_prefill_step(
            tp, {"frames": tf, "tokens": tt[:, :PROMPT]}, cfg=tc, sp_cfg=tsp)
        tcache = _seat(tc_, PROMPT + DECODE)
        for step in range(DECODE):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                       rtol=0, err_msg=f"step {step}")
            tok = np.array(jnp.argmax(jl[:, -1, :jc.vocab], -1))[:, None]
            jl, jcache = dec(jp, jcache, je, jnp.asarray(tok, jnp.int32),
                             jnp.int32(PROMPT + step))
            tl, tcache = TST.encdec_decode_step(
                tp, tcache, te, torch.from_numpy(tok).long(), PROMPT + step,
                cfg=tc, sp_cfg=tsp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    assert all(lc["pos"] == PROMPT + DECODE for lc in tcache["layers"])


def _hazard_gaps(method):
    """(seated gap, unseated gap) in each package: the last of 9 tokens'
    logits from one 9-token prefill against an 8-token prefill and one
    decode step at position 8, the cache seated in a 9-long one or
    not."""
    jc, tc = _cfgs()
    jsp, tsp = _sp(method)
    (jf, jt), (tf, tt) = _inputs()
    pre, dec = _jsteps(method)
    jfull = pre(_jparams(), {"frames": jf, "tokens": jt})[0]
    jl, jcache, je = pre(_jparams(), {"frames": jf, "tokens": jt[:, :-1]})
    ref = []
    for cache in (_jseat(jcache, PROMPT + 1), jcache):
        step, _ = dec(_jparams(), cache, je, jt[:, -1:], jnp.int32(PROMPT))
        ref.append(float(jnp.abs(step - jfull)[..., :jc.vocab].max()))
    port = []
    tp = _tparams()
    with torch.no_grad():
        tfull = TST.encdec_prefill_step(tp, {"frames": tf, "tokens": tt},
                                        cfg=tc, sp_cfg=tsp)[0]
        for seat in (True, False):
            _, cache, te = TST.encdec_prefill_step(
                tp, {"frames": tf, "tokens": tt[:, :-1]}, cfg=tc, sp_cfg=tsp)
            if seat:
                cache = _seat(cache, PROMPT + 1)
            step, _ = TST.encdec_decode_step(tp, cache, te, tt[:, -1:],
                                             PROMPT, cfg=tc, sp_cfg=tsp)
            port.append(float((step - tfull)[..., :tc.vocab].abs().max()))
    return ref, port


@pytest.mark.parametrize("method", METHODS)
def test_unseated_prefill_cache_decodes_over_the_last_prompt_position(
        method):
    """The reference hazard: decoding on the prefill's own cache writes
    position 8's K/V over position 7's (the cursor clamped to s - 1), so
    its logits part from the 9-token prefill's; seated in a longer cache
    they agree to bf16 noise.  The port does the same, gap for gap."""
    ref, port = _hazard_gaps(method)
    print(f"{method}: seated / unseated gap, reference {ref[0]:.3f} / "
          f"{ref[1]:.3f}, port {port[0]:.3f} / {port[1]:.3f}")
    for seated, unseated in (ref, port):
        assert unseated > 0.2 and unseated > 10 * seated
    assert abs(ref[1] - port[1]) <= GAP_ATOL


def test_decoder_self_attention_ropes_over_learned_positions():
    """The reference hazard: the decoder's cached keys are RoPE'd (at
    their positions) on top of the learned positions, in both packages;
    position 0's keys are the plain projection's (RoPE at 0 is the
    identity)."""
    jc, tc = _cfgs()
    jsp, tsp = _sp("dense")
    (jf, jt), (tf, tt) = _inputs()
    pre, _ = _jsteps("dense")
    jk = np.asarray(pre(_jparams(), {"frames": jf, "tokens": jt})[1][
        "layers"]["k"][0]).astype(np.float32)
    tp = _tparams()
    with torch.no_grad():
        _, cache, _ = TST.encdec_prefill_step(tp, {"frames": tf,
                                                   "tokens": tt},
                                              cfg=tc, sp_cfg=tsp)
        x = TL.embed_apply(tp["embed"], tt) + tp["pos_embed_dec"][
            :tt.shape[1]].to(torch.bfloat16)
        h = TL.layernorm_apply(tp["dec_blocks"][0]["ln1"], x)
        k = TL.dense_apply(tp["dec_blocks"][0]["attn"]["k_proj"], h,
                           "attn/k_proj", tsp).reshape(
            BATCH, -1, tc.n_kv, tc.head_dim)
    tk = cache["layers"][0]["k"]
    np.testing.assert_allclose(tk.float().numpy(), jk, atol=ATOL, rtol=0)
    assert torch.equal(tk[:, 0], k[:, 0])
    assert float((tk[:, 1:].float() - k[:, 1:].float()).abs().max()) > 0.1
    positions = torch.arange(tt.shape[1]).expand(BATCH, -1)
    assert torch.equal(tk, TL.apply_rope(k, positions))


def test_decode_step_projects_the_cross_kv_again_in_every_layer(
        monkeypatch):
    """The reference hazard: a decode step projects every decoder
    layer's cross-attention k and v from the encoder output again (the
    packed product at B x T_enc rows), besides the layer's 8 other
    projections at B rows: 10 per layer."""
    _, tc = _cfgs()
    _, tsp = _sp("bdwp")
    _, (tf, tt) = _inputs()
    tp = pack_tree_element(_tparams(), tsp, device="cpu")[0]
    with torch.no_grad():
        _, cache, enc = TST.encdec_prefill_step(
            tp, {"frames": tf, "tokens": tt[:, :PROMPT]}, cfg=tc, sp_cfg=tsp)
        cache = _seat(cache, PROMPT + 1)
        rows = []
        spmm = ops.nm_spmm
        monkeypatch.setattr(ops, "nm_spmm", lambda act, *a, **k: rows.append(
            act.shape[0]) or spmm(act, *a, **k))
        TST.encdec_decode_step(tp, cache, enc, tt[:, PROMPT:PROMPT + 1],
                               PROMPT, cfg=tc, sp_cfg=tsp)
    assert len(rows) == 10 * tc.n_layers
    assert rows.count(BATCH * FRAMES) == 2 * tc.n_layers
    assert rows.count(BATCH) == 8 * tc.n_layers


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    """A train state of both block lists, restored, equals the saved one
    bitwise and trains on to the same loss."""
    from repro_torch.train.checkpoint import CheckpointManager

    _, tc = _cfgs()
    _, tsp = _sp("bdwp")
    state = TST.init_train_state(tc, tsp, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    back = mgr.restore(state, device="cpu")
    assert isinstance(back["compute"]["dec_blocks"][1]["xattn"]["v_proj"][
        "w"], PregenOp)
    for key in ("master", "momentum", "compute"):
        for a, b in zip(TSGD.tree_leaves(state[key]),
                        TSGD.tree_leaves(back[key])):
            for f in (("bp", "vals", "idx", "mask")
                      if isinstance(a, PregenOp) else (None,)):
                x, y = (a, b) if f is None else (getattr(a, f),
                                                 getattr(b, f))
                assert x.dtype == y.dtype and torch.equal(x, y), (key, f)
    _, batch = next(encdec_stream(tc.vocab, BATCH, 16, tc.d_model,
                                  enc_frames=FRAMES, device="cpu"))
    fn = functools.partial(TST.encdec_train_step, cfg=tc, sp_cfg=tsp,
                           opt_cfg=TSGD.SGDConfig(lr=0.1, warmup_steps=2))
    assert float(fn(state, batch)[1]["loss"]) == float(
        fn(back, batch)[1]["loss"])
    assert TA.init_cache(tc.attn_cfg(), 1, 4, device="cpu")["pos"] == 0
