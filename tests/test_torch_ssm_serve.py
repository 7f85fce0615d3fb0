"""Serving mamba2-370m and hymba-1.5b at SMOKE size against the JAX
reference, on the CPU: the element pack's site set and byte report,
prefill with a cache then teacher-forced decode (per slot and with the
shared cursor; hymba's past its 16-token window), the packed engines'
greedy streams with a request joining mid-flight, the batcher's seat
and extract of the SSM caches, the reference hazard of the padded
prefill, a hymba-shaped variant whose in_proj is no site, and a
checkpoint round trip.

The caches: a mamba layer keeps ``{"state" (B, H, N, P), "conv"
(B, K-1, C)}`` in fp32, a hybrid layer those beside its bf16
``{"k", "v", "pos"}``.  The reference's prefill cache is seated in a
deeper ``init_lm_cache`` for its decode (the SSM leaves whole).

The reference hazard (ROADMAP queue 3): the serve engine right-pads
every prompt to ``prompt_bucket``; attention masks the pad positions,
the SSM does not, so the state and the conv window a padded prefill
leaves behind are taken after the pad tokens.  The prefill's logits are
unchanged, the first decode step's are not; the port does what the
reference does, gap for gap.

Tolerances: logits within ``ATOL`` = 4e-2 (``test_torch_ssm_lm.py``);
the SSM state after prefill within ``STATE_ATOL`` = 2e-3 (fp32 sums in
other orders, bf16 inputs an ulp apart now and then; measured below
5e-4), the conv window bitwise; the hazard's decode gaps within
``GAP_ATOL`` = 0.25 of the reference's (measured equal: 3.317 for
mamba2, largest logit 2.69, and 3.567 for hymba, 3.00; the padded state
is garbage, so an ulp in it may move the gap by tenths); the engines'
streams and byte reports equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import transformer_lm as JT
from repro.optim import sgd as JSGD
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.packed_params import pack_tree_element as j_pack
from repro.train import step as JST
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.operand import PackedOp, PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.models import transformer_lm as TT
from repro_torch.optim import sgd as TSGD
from repro_torch.serve import batcher as TBA
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.packed_params import pack_tree_element
from repro_torch.train import step as TST

jax.config.update("jax_platform_name", "cpu")

ARCH_IDS = ["mamba2-370m", "hymba-1.5b"]
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
J_DENSE = JSparsity(n=2, m=8, method="dense")
T_DENSE = SparsityConfig(n=2, m=8, method="dense")
ATOL = 4e-2
STATE_ATOL = 2e-3
GAP_ATOL = 0.25
DECODE_STEPS = 10        # 12 + 10 positions: past hymba's window of 16
PACKED = {"mamba2-370m": ("ssm/in_proj", "ssm/out_proj"),
          "hymba-1.5b": ("ssm/in_proj", "ssm/out_proj", "attn/q_proj",
                         "attn/k_proj", "attn/v_proj", "attn/o_proj",
                         "ffn/w_gate", "ffn/w_up", "ffn/w_down")}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    return j_get_arch(arch).smoke, get_arch(arch).smoke


@functools.lru_cache(maxsize=None)
def _jparams(arch, **over):
    jc = dataclasses.replace(_cfgs(arch)[0], **over)
    p, _ = JT.init(jax.random.PRNGKey(0), jc)
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


def _tparams(arch, **over):
    return convert.params_from_jax(_np(_jparams(arch, **over)), device="cpu")


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


# -- the element pack ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_element_pack_site_set_matches_reference(arch):
    """in_proj and out_proj (and hymba's attention and FFN) are packed
    (u4); the conv, A_log, D, dt_bias and the norms stay dense, bf16;
    the stats are the reference's."""
    _, jstats = j_pack(_jparams(arch), J_SP, idx_bits=4)
    packed, stats = pack_tree_element(_tparams(arch), T_SP, idx_bits=4,
                                      device="cpu")
    assert stats == jstats
    assert stats["n_packed"] == len(PACKED[arch])
    for blk in packed["blocks"]:
        for name in PACKED[arch]:
            assert isinstance(_at(blk, name)["w"], PackedOp), name
        for name in ("conv_w", "A_log", "D", "dt_bias"):
            assert blk["ssm"][name].dtype == torch.bfloat16


def test_dense_in_proj_variant_matches_reference():
    """hymba SMOKE with ``ssm_head_dim=32`` (in_proj F = 292, not a
    multiple of 8), as FULL's (1600 x 6482): in_proj is no site and no
    packed weight, trains as a dense bf16 copy (the step-0 compute tree
    bitwise) and serves dense (counted in ``n_dense``), and the forward
    matches the reference."""
    arch, over = "hymba-1.5b", dict(ssm_head_dim=32)
    jc = dataclasses.replace(_cfgs(arch)[0], **over)
    tc = dataclasses.replace(_cfgs(arch)[1], **over)
    assert tc.ssm_cfg().d_in_proj == 292
    _, jstats = j_pack(_jparams(arch, **over), J_SP, idx_bits=4)
    packed, stats = pack_tree_element(_tparams(arch, **over), T_SP,
                                      idx_bits=4, device="cpu")
    assert stats == jstats and stats["n_packed"] == len(PACKED[arch]) - 1
    assert stats["n_dense"] == jstats["n_dense"] >= 1
    w = packed["blocks"][0]["ssm"]["in_proj"]["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
    jmaster = jax.jit(lambda k: JST.init_train_state(
        k, jc, sp_cfg=J_SP, pregen=False))(jax.random.PRNGKey(0))["master"]
    jcomp = jax.jit(lambda m: JSGD.pregen_tree(m, J_SP, pack=True))(jmaster)
    comp = TSGD.pregen_tree(convert.params_from_jax(_np(jmaster),
                                                    device="cpu"),
                            T_SP, pack=True)
    for i, blk in enumerate(comp["blocks"]):
        tw = blk["ssm"]["in_proj"]["w"]
        jw = np.asarray(jcomp["blocks"]["ssm"]["in_proj"]["w"][i])
        assert not isinstance(tw, PregenOp) and tw.dtype == torch.bfloat16
        assert np.array_equal(tw.view(torch.int16).numpy(),
                              jw.view(np.int16))
        assert isinstance(blk["ssm"]["out_proj"]["w"], PregenOp)
    toks = np.random.default_rng(3).integers(0, jc.vocab, (2, 32))

    @jax.jit
    def ref(p, t):
        return JT.logits_from_hidden(p, JT.forward(p, t, jc, J_SP)[0], jc)

    tp = _tparams(arch, **over)
    with torch.no_grad():
        logits = TT.logits_from_hidden(tp, TT.forward(
            tp, torch.from_numpy(toks), tc, T_SP)[0], tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref(
        _jparams(arch, **over), jnp.asarray(toks, jnp.int32))), atol=ATOL,
        rtol=0)


# -- prefill and decode ---------------------------------------------------


def _j_seat(dst, src):
    if dst.ndim == 0 or dst.shape == src.shape:
        return src.astype(dst.dtype)
    return dst.at[tuple(slice(0, d) for d in src.shape)].set(
        src.astype(dst.dtype))


def _t_grow(cfg, cache, max_len):
    """A prefill cache copied into a deeper one: k/v by position, the
    SSM's state and conv window whole, the cursors."""
    b = len(next(iter(cache["layers"][0].values())))
    out = TT.init_lm_cache(cfg, b, max_len, device="cpu")
    for dst, src in zip(out["layers"], cache["layers"]):
        for key, t in src.items():
            if key in ("state", "conv"):
                dst[key].copy_(t)
            elif isinstance(t, torch.Tensor):
                dst[key][:, :t.shape[1]] = t
            else:
                dst[key] = t
    return out


def _assert_ssm_cache_close(jcache, tcache):
    for i, lc in enumerate(tcache["layers"]):
        assert lc["state"].dtype == lc["conv"].dtype == torch.float32
        np.testing.assert_allclose(
            lc["state"].numpy(), np.asarray(jcache["layers"]["state"][i]),
            atol=STATE_ATOL, rtol=0)
        assert np.array_equal(lc["conv"].numpy(),
                              np.asarray(jcache["layers"]["conv"][i]))


@pytest.mark.parametrize("mode", ["per_slot", "shared_cursor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch, mode):
    """u4-packed weights: a prefill of two right-padded prompts (9 and 12
    tokens in a 12-token batch), its SSM caches, then teacher-forced
    decode steps (hymba's windowed attention past its window)."""
    jc, tc = _cfgs(arch)
    jp, _ = j_pack(_jparams(arch), J_SP, idx_bits=4)
    tp, _ = pack_tree_element(_tparams(arch), T_SP, idx_bits=4,
                              device="cpu")
    rng = np.random.default_rng(7)
    lens = (9, 12)
    toks = np.zeros((2, 12), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, jc.vocab, n)
    last = np.asarray(lens) - 1
    max_len = 12 + DECODE_STEPS + 1
    lj, cj = jax.jit(lambda p, t, li: JST.lm_prefill_step(
        p, {"tokens": t}, cfg=jc, sp_cfg=J_SP, last_index=li))(
        jp, jnp.asarray(toks), jnp.asarray(last))
    with torch.no_grad():
        lt, ct = TST.lm_prefill_step(tp, {"tokens": torch.from_numpy(
            toks.astype(np.int64))}, cfg=tc, sp_cfg=T_SP, last_index=last)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    _assert_ssm_cache_close(cj, ct)
    cj = jax.tree.map(_j_seat, JT.init_lm_cache(jc, 2, max_len), cj)
    ct = _t_grow(tc, ct, max_len)
    per_slot = mode == "per_slot"
    j_decode = jax.jit(lambda p, c, t, pos: JST.lm_decode_step(
        p, c, t, pos, cfg=jc, sp_cfg=J_SP, per_slot=per_slot))
    pos = last + 1 if per_slot else np.int32(12)
    for step in range(DECODE_STEPS):
        tok = np.argmax(np.asarray(lj)[:, -1, :jc.vocab], -1)[:, None]
        lj, cj = j_decode(jp, cj, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            lt, ct = TST.lm_decode_step(tp, ct, torch.from_numpy(tok),
                                        torch.as_tensor(pos), cfg=tc,
                                        sp_cfg=T_SP, per_slot=per_slot)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        pos = pos + 1
    _assert_ssm_cache_close(cj, ct)


def _hazard(arch, pkg):
    """A 5-token prompt prefilled alone and right-padded to 16 (dense
    weights): (prefill logits alone, padded), layer 0's state alone and
    padded, and the first decode step's logits after each."""
    jc, tc = _cfgs(arch)
    prompt = np.random.default_rng(5).integers(0, jc.vocab, 5)
    padded = np.zeros(16, np.int64)
    padded[:5] = prompt
    nxt = np.asarray([[int(prompt[-1])]])
    out = []
    for toks in (prompt[None].astype(np.int64), padded[None]):
        if pkg == "ref":
            lg, cache = jax.jit(lambda p, t: JST.lm_prefill_step(
                p, {"tokens": t}, cfg=jc, sp_cfg=J_DENSE,
                last_index=jnp.asarray([4])))(_jparams(arch),
                                              jnp.asarray(toks, jnp.int32))
            state = np.asarray(cache["layers"]["state"][0])
            cache = jax.tree.map(_j_seat, JT.init_lm_cache(jc, 1, 24), cache)
            step, _ = jax.jit(lambda p, c, t: JST.lm_decode_step(
                p, c, t, jnp.asarray([5]), cfg=jc, sp_cfg=J_DENSE,
                per_slot=True))(_jparams(arch), cache,
                                jnp.asarray(nxt, jnp.int32))
            out.append((np.asarray(lg), state, np.asarray(step)))
        else:
            tp = _tparams(arch)
            with torch.no_grad():
                lg, cache = TST.lm_prefill_step(
                    tp, {"tokens": torch.from_numpy(toks)}, cfg=tc,
                    sp_cfg=T_DENSE, last_index=[4])
                state = cache["layers"][0]["state"].numpy().copy()
                cache = _t_grow(tc, cache, 24)
                step, _ = TST.lm_decode_step(
                    tp, cache, torch.from_numpy(nxt), torch.tensor([5]),
                    cfg=tc, sp_cfg=T_DENSE)
            out.append((lg.numpy(), state, step.numpy()))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_padded_prefill_leaves_a_padded_ssm_state_as_reference(arch):
    """The reference hazard: the same prompt prefilled alone and
    right-padded gives the same logits, but another SSM state (taken
    after the pad tokens) and another first decode step, in both
    packages (gaps printed, as the MLA test does)."""
    gaps = {}
    for pkg in ("ref", "port"):
        (l1, s1, d1), (l2, s2, d2) = _hazard(arch, pkg)
        np.testing.assert_allclose(l1, l2, atol=1e-5, rtol=0)
        gaps[pkg] = (float(np.abs(s1 - s2).max()),
                     float(np.abs(d1 - d2).max()),
                     float(np.abs(d1[..., :512]).max()))
    print(f"{arch}: (state gap, decode gap, largest logit) {gaps}")
    for pkg in ("ref", "port"):
        assert gaps[pkg][0] > 1e-2 and gaps[pkg][1] > 1.0, gaps
    assert abs(gaps["port"][1] - gaps["ref"][1]) <= GAP_ATOL, gaps


# -- the engine and the batcher ---------------------------------------------


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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_streams_match_reference(arch):
    """The packed (u4) engines' greedy streams are equal, a request
    joining mid-flight (its prefill seats SSM caches), and so are the
    byte reports; a batched stream equals its solo stream."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32)
               for n in (4, 12, 8)]
    new = (6, 12, 8)
    kw = dict(n_slots=2, max_len=32, prompt_bucket=12, packed=True,
              idx_bits=4)
    jeng = JServeEngine(_jparams(arch), jc, J_SP, JServeConfig(**kw))
    teng = ServeEngine(_tparams(arch), tc, T_SP, ServeConfig(**kw),
                       device="cpu")
    want = _mixed_run(jeng, prompts, new)
    with torch.no_grad():
        assert _mixed_run(teng, prompts, new) == want
        assert teng.hbm_report() == jeng.hbm_report()
        teng.reset()
        solo = teng.submit(prompts[1], max_new_tokens=new[1])
        assert teng.run()[solo] == want[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_seat_and_extract_round_trip_of_ssm_caches(arch):
    """A batch-1 prefill cache seats into lane 1 of a 3-slot cache: k/v
    by position, the state and conv window whole (their axis 1 is heads
    and taps); extracting the lane gives them back bitwise; a lane of
    another width is refused."""
    _, tc = _cfgs(arch)
    with torch.no_grad():
        _, pre = TST.lm_prefill_step(_tparams(arch), {"tokens": torch.arange(
            1, 9)[None]}, cfg=tc, sp_cfg=T_SP)
    cache = TT.init_lm_cache(tc, 3, 20, device="cpu")
    TBA.seat_cache(cache, pre, 1)
    back = TBA.extract_lane_cache(cache, 1, 3)
    for lc, src, got in zip(cache["layers"], pre["layers"], back["layers"]):
        for key in ("state", "conv"):
            assert torch.equal(got[key], src[key]), key
            assert not lc[key][0].any() and not lc[key][2].any()
        if "k" in src:
            assert torch.equal(got["k"][:, :8], src["k"])
    bad = {"layers": [{k: (v[:, :, :-1] if k == "state" else v)
                       for k, v in lc.items()} for lc in pre["layers"]]}
    with pytest.raises(ValueError, match="state"):
        TBA.seat_cache(cache, bad, 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_checkpoint_round_trip(arch, tmp_path):
    """A train state (the SSD block's sites and its small leaves),
    restored, equals the saved one bitwise and trains on to the same
    loss."""
    from repro_torch.train.checkpoint import CheckpointManager

    tc = _cfgs(arch)[1]
    state = TST.init_train_state(tc, T_SP, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    back = mgr.restore(state, device="cpu")
    assert isinstance(back["compute"]["blocks"][0]["ssm"]["out_proj"]["w"],
                      PregenOp)
    for key in ("master", "momentum", "compute"):
        for a, b in zip(TSGD.tree_leaves(state[key]),
                        TSGD.tree_leaves(back[key])):
            for f in (("bp", "vals", "idx", "mask")
                      if isinstance(a, PregenOp) else (None,)):
                x, y = (a, b) if f is None else (getattr(a, f),
                                                 getattr(b, f))
                assert x.dtype == y.dtype and torch.equal(x, y), (key, f)
    _, batch = next(lm_stream(tc.vocab, 2, 32, device="cpu"))
    fn = functools.partial(TST.lm_train_step, cfg=tc, sp_cfg=T_SP,
                           opt_cfg=TSGD.SGDConfig(lr=0.1, warmup_steps=2))
    assert float(fn(state, batch)[1]["loss"]) == float(
        fn(back, batch)[1]["loss"])
