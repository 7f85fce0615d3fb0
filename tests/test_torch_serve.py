"""Port parity for the serve engine (qwen3-8b SMOKE, CPU).

The port's ``ServeEngine(device="cpu")`` and the reference's JAX
``ServeEngine`` get the same bf16 params and prompts, for packed u4,
packed u8 and masked weights:

* under teacher forcing (both fed the reference's greedy tokens, one
  request at a time) the logits agree within ATOL = 1e-4.  At batch 1
  the port's hidden states equal the reference's bit for bit (it mirrors
  the bf16 arithmetic op for op), so the logits differ only by the fp32
  summation order of the lm_head product over d_model = 64 terms,
  ~1e-6;
* every reference step's top-2 logit margin exceeds 2 * ATOL, so the
  greedy choice cannot flip within the tolerance (a seed that fails
  here says so, rather than as a stream mismatch);
* the greedy streams of the two engines are then required to be equal,
  with a request joining mid-flight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import transformer_lm as JT
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train import step as JST
from repro_torch import convert
from repro_torch.configs import qwen3_8b as TC
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import nm_spmm as K
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.packed_params import pack_tree_element
from repro_torch.train import step as ST

jax.config.update("jax_platform_name", "cpu")

J_CFG = get_arch("qwen3-8b").smoke
T_CFG = TC.SMOKE
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
ATOL = 1e-4
BUCKET, MAX_LEN, SLOTS = 12, 32, 2
LENS, NEW = (4, 8, 12), (4, 10, 8)
MODES = {"packed4": (True, 4), "packed8": (True, 8), "masked": (False, None)}


@pytest.fixture(scope="module")
def jparams():
    p, _ = JT.init(jax.random.PRNGKey(0), J_CFG)
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")


def _prompts(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, J_CFG.vocab, n).astype(np.int32) for n in LENS]


def _serve_cfgs(mode):
    packed, bits = MODES[mode]
    kw = dict(n_slots=SLOTS, max_len=MAX_LEN, prompt_bucket=BUCKET,
              packed=packed, idx_bits=bits)
    return JServeConfig(**kw), ServeConfig(**kw)


def _mixed_run(engine, prompts):
    """r0, r1 start together; r2 joins when r0's slot frees."""
    r0 = engine.submit(prompts[0], max_new_tokens=NEW[0])
    r1 = engine.submit(prompts[1], max_new_tokens=NEW[1])
    r2 = None
    while engine.n_running or engine.n_queued or r2 is None:
        events = engine.step()
        if r2 is None and r0 in events["finished"]:
            r2 = engine.submit(prompts[2], max_new_tokens=NEW[2])
    out = engine.harvest()
    return [out[r0], out[r1], out[r2]]


@jax.jit
def _j_prefill(params, tokens, last_index):
    return JST.lm_prefill_step(params, {"tokens": tokens}, cfg=J_CFG,
                               sp_cfg=J_SP, last_index=last_index)


@jax.jit
def _j_decode(params, cache, token, pos):
    return JST.lm_decode_step(params, cache, token, pos, cfg=J_CFG,
                              sp_cfg=J_SP, per_slot=True)


def _teacher_forced(jp, tp, prompt, n_new):
    """Reference greedy stream, with both packages' logits along it."""
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, :len(prompt)] = prompt
    last = [len(prompt) - 1]
    lj, cj = _j_prefill(jp, jnp.asarray(toks), jnp.asarray(last))
    lt, ct = ST.lm_prefill_step(tp, {"tokens": torch.from_numpy(toks)},
                                cfg=T_CFG, sp_cfg=T_SP, last_index=last)
    stream, ref_logits, port_logits = [], [], []
    pos = len(prompt)
    for i in range(n_new):
        ref_logits.append(np.asarray(lj)[0, -1, :J_CFG.vocab])
        port_logits.append(lt.numpy()[0, -1, :T_CFG.vocab])
        stream.append(int(np.argmax(ref_logits[-1])))
        if i == n_new - 1:
            break
        tok = np.asarray([[stream[-1]]], np.int32)
        p = np.asarray([pos], np.int32)
        lj, cj = _j_decode(jp, cj, jnp.asarray(tok), jnp.asarray(p))
        lt, ct = ST.lm_decode_step(tp, ct, torch.from_numpy(tok),
                                   torch.from_numpy(p), cfg=T_CFG,
                                   sp_cfg=T_SP)
        pos += 1
    return stream, np.stack(ref_logits), np.stack(port_logits)


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_reference_engine(jparams, tparams, mode):
    jcfg, tcfg = _serve_cfgs(mode)
    prompts = _prompts()
    jeng = JServeEngine(jparams, J_CFG, J_SP, jcfg)
    launches = K.launches
    teng = ServeEngine(tparams, T_CFG, T_SP, tcfg, device="cpu")
    # teacher forcing on the engines' own (packed or masked) params
    jp = jeng.batcher.params
    for prompt, n_new in zip(prompts, NEW):
        stream, ref, port = _teacher_forced(jp, teng.batcher.params, prompt,
                                            n_new)
        np.testing.assert_allclose(port, ref, atol=ATOL, rtol=0)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        assert margin.min() > 2 * ATOL, (
            f"seed too close to a tie for this tolerance: margin "
            f"{margin.min():.4f} <= {2 * ATOL}")
    want = _mixed_run(jeng, prompts)
    got = _mixed_run(teng, prompts)
    assert got == want
    assert [len(s) for s in got] == list(NEW)
    assert K.launches == launches        # the CPU path launches no kernel
    if tcfg.packed:
        # both count a weight name once, however many layers hold it
        assert teng.hbm_report() == jeng.hbm_report()
    else:
        assert teng.hbm_report() is None


def test_mid_flight_join_matches_solo(tparams):
    prompts = _prompts(seed=5)
    _, tcfg = _serve_cfgs("packed4")
    eng = ServeEngine(tparams, T_CFG, T_SP, tcfg, device="cpu")
    solo = []
    for p, n in zip(prompts, NEW):
        rid = eng.submit(p, max_new_tokens=n)
        solo.append(eng.run()[rid])
    eng.reset()
    assert _mixed_run(eng, prompts) == solo
    stats = eng.stats()
    assert stats["prefill_steps"] == 3 and stats["decoded_tokens"] == sum(NEW)


def test_lane_export_and_prefix_pool(tparams):
    """A running request moved to another engine continues its stream;
    a prefix-pool hit seats the pooled lane without a prefill."""
    prompts = _prompts(seed=9)
    _, tcfg = _serve_cfgs("packed4")
    a = ServeEngine(tparams, T_CFG, T_SP, tcfg, device="cpu")
    rid = a.submit(prompts[1], max_new_tokens=10)
    solo = a.run()[rid]
    rid = a.submit(prompts[1], max_new_tokens=10)
    for _ in range(3):
        a.step()
    tokens = list(a._running.values())[0].tokens
    lane = a.export_lane(rid)
    b = ServeEngine(tparams, T_CFG, T_SP, tcfg, device="cpu")
    rb = b.submit_lane(lane, max_new_tokens=10, tokens=tokens)
    assert b.run()[rb] == solo and b.prefill_steps == 0

    pooled = ServeEngine(tparams, T_CFG, T_SP,
                         ServeConfig(**{**tcfg.__dict__, "prefix_cache": 2}),
                         device="cpu")
    streams = []
    for _ in range(2):
        r = pooled.submit(prompts[1], max_new_tokens=10)
        streams.append(pooled.run()[r])
    assert streams == [solo, solo] and pooled.prefill_steps == 1
    assert pooled.stats()["prefix_pool"]["hits"] == 1


def test_submit_validation(tparams):
    eng = ServeEngine(tparams, T_CFG, T_SP, _serve_cfgs("packed4")[1],
                      device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(BUCKET + 1)))
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit([])
    with pytest.raises(ValueError, match="KV capacity"):
        eng.submit([1, 2, 3], max_new_tokens=MAX_LEN)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2, 3], max_new_tokens=0)


def test_packed_store_layerwise_equals_whole_tree(tparams):
    from repro_torch.serve.packed_params import PackedParamStore

    whole = PackedParamStore.pack(tparams, T_SP, device="cpu")
    shell = {k: v for k, v in tparams.items() if k != "blocks"}
    layered = PackedParamStore.pack_layerwise(shell, iter(tparams["blocks"]),
                                              T_SP, device="cpu")
    assert layered.report() == whole.report()
    a = layered.params["blocks"][1]["attn"]["o_proj"]["w"]
    b = pack_tree_element(tparams, T_SP, device="cpu")[0]["blocks"][1][
        "attn"]["o_proj"]["w"]
    assert torch.equal(a.vals, b.vals) and torch.equal(a.idx, b.idx)
