"""Port parity of mamba2-370m and hymba-1.5b at SMOKE size against the
JAX reference, on the CPU: the registry and configs, the parameter
counts at FULL, the converted tree, the forward logits, and BDWP 2:8
training on both dataflows (the step-0 compute tree and its site set,
three pre-generated packed steps and three legacy ``pregen=False``
steps).  mamba2's SMOKE is 2 layers of a Mamba-2 SSD block alone
(d_inner 128, 8 heads of 16, state 16, chunks of 16); hymba's is 2
hybrid layers (windowed attention, window 16, and an SSD block on the
same input, mean-combined, then a dense FFN of 128).  Serving is in
``test_torch_ssm_serve.py``, the update given the same gradients in
``test_torch_ssm_update.py``, the SSD block alone in
``test_torch_ssm.py``.

The reference's params and train states are loaded with ``convert``;
the same numpy-seeded batches feed both.  The reference's forward and
steps are jitted, its train step built on a mesh of ``AxisType.Auto``
axes (ROADMAP queue 3), its update on its jnp path (``use_pallas=
False``).  Each SSD block alone is bitwise the compiled reference's on
these inputs (the port mirrors its fusion of the output gate into the
norm); the whole model lands an fp32 sum an ulp away now and then.

Tolerances: logits within ``ATOL`` = 4e-2, granite's and deepseek's
limit (measured 4.8e-7 for mamba2 and 2.7e-2 for hymba on the test's
batch: a bf16 ulp at one SSD output reaches every later position
through the state); the loss of three steps within ``LOSS_ATOL`` =
(1e-3, 2e-3, 3e-2) a step (measured up to 1.3e-3 for mamba2 and 1.5e-2
for hymba's legacy step 2; qwen3-8b's SMOKE moves 1.4e-2 by step 2,
ROADMAP queue 3); the compute tree bitwise.
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
from repro.train import step as JST
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import hymba_1_5b, mamba2_370m
from repro_torch.core.operand import PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.models import transformer_lm as TT
from repro_torch.optim import sgd as TSGD
from repro_torch.train import step as TST
from repro_torch.train import trainer as TTR
from torch_sync_helpers import check_pod_split_metrics

jax.config.update("jax_platform_name", "cpu")

ARCH_IDS = ["mamba2-370m", "hymba-1.5b"]
MODULES = {"mamba2-370m": mamba2_370m, "hymba-1.5b": hymba_1_5b}
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
J_OPT = JSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
T_OPT = TSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
ATOL = 4e-2
LOSS_ATOL = (1e-3, 2e-3, 3e-2)
BATCH, SEQ = 2, 32
CFG_FIELDS = ("name", "vocab", "d_model", "n_layers", "n_heads", "n_kv",
              "head_dim", "d_ff", "rope_theta", "qk_norm", "qkv_bias",
              "pattern", "window", "tie_embed", "pad_vocab_to",
              "padded_vocab", "remat", "ssm_state", "ssm_head_dim",
              "ssm_chunk", "has_attn", "has_ssm", "uses_scan_prelude")
SSM_FIELDS = ("d_model", "d_state", "head_dim", "expand", "d_conv", "chunk",
              "d_inner", "n_heads", "conv_dim")
# reference parameter counts (``LMConfig.n_params``) at FULL
N_PARAMS = {"mamba2-370m": 368_432_640, "hymba-1.5b": 1_589_975_296}
# the sites of a layer: the SSD block's projections, and hymba's
# attention and FFN
SITES = {"mamba2-370m": ("ssm/in_proj", "ssm/out_proj"),
         "hymba-1.5b": ("ssm/in_proj", "ssm/out_proj", "attn/q_proj",
                        "attn/k_proj", "attn/v_proj", "attn/o_proj",
                        "ffn/w_gate", "ffn/w_up", "ffn/w_down")}
NOT_SITES = ("ssm/conv_w", "ssm/A_log", "ssm/D", "ssm/dt_bias",
             "ssm/ssm_norm/norm_scale", "ln1/norm_scale", "ln2/norm_scale")


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


def _cfgs(arch):
    return j_get_arch(arch).smoke, get_arch(arch).smoke


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    p, _ = JT.init(jax.random.PRNGKey(0), _cfgs(arch)[0])
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


def _tparams(arch):
    return convert.params_from_jax(_np(_jparams(arch)), device="cpu")


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


# -- the registry and the configs ------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_returns_the_arch_spec_and_configs_match_reference(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    assert ARCHS[arch] is t is MODULES[arch].ARCH
    for field in ("arch_id", "family", "kind", "source", "sub_quadratic",
                  "prefix_len"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.supports("long_500k")
    for jc, tc in ((j.full, t.full), (j.smoke, t.smoke)):
        for field in CFG_FIELDS:
            assert getattr(tc, field) == getattr(jc, field), (jc.name, field)
        for field in SSM_FIELDS:
            assert getattr(tc.ssm_cfg(), field) == getattr(jc.ssm_cfg(),
                                                           field), field
        assert tc.layer_kinds() == jc.layer_kinds()
        assert tc.layer_window(tc.layer_kinds()[0]) == tc.window
    # TRAIN: FULL itself, every width and all layers
    assert MODULES[arch].TRAIN == t.full


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_at_full_equal_the_reference(arch):
    assert get_arch(arch).full.n_params() == N_PARAMS[arch]
    assert get_arch(arch).full.n_active_params() == N_PARAMS[arch]
    assert j_get_arch(arch).smoke.n_params() == get_arch(arch).smoke.n_params()


def test_unknown_layer_kind_is_refused():
    with pytest.raises(ValueError, match="unknown layer kinds"):
        dataclasses.replace(get_arch("mamba2-370m").smoke, pattern=("rnn",))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_converted_tree_and_the_ports_own_init(arch):
    """Per-layer SSD leaves ((L, 4, C) conv_w -> (4, C), (L, H) -> (H,));
    mamba2's blocks have ln1, ln2 and ssm only; the port's init draws
    the same leaves, and its deterministic ones are the reference's
    (A_log within an ulp: two libms' log)."""
    jc, tc = _cfgs(arch)
    tp = _tparams(arch)
    blk = tp["blocks"][0]
    want = {"mamba2-370m": ["ln1", "ln2", "ssm"],
            "hymba-1.5b": ["attn", "ffn", "ln1", "ln2", "ssm"]}[arch]
    assert sorted(blk) == want and len(tp["blocks"]) == tc.n_layers
    sc = tc.ssm_cfg()
    assert tuple(blk["ssm"]["conv_w"].shape) == (sc.d_conv, sc.conv_dim)
    assert tuple(blk["ssm"]["in_proj"]["w"].shape) == (tc.d_model,
                                                       sc.d_in_proj)
    for k in ("A_log", "D", "dt_bias"):
        assert tuple(blk["ssm"][k].shape) == (sc.n_heads,)

    def shapes(tree):
        out = []
        TSGD.tree_map(lambda n, x: out.append((n, tuple(x.shape))), tree)
        return sorted(out)

    own = TT.init(tc, device="cpu")
    assert shapes(own) == shapes(tp)
    jp, _ = JT.init(jax.random.PRNGKey(0), jc)
    jssm = jax.tree.map(lambda a: np.asarray(a)[0], jp["blocks"]["ssm"])
    tssm = own["blocks"][0]["ssm"]
    for k in ("D", "dt_bias"):
        assert np.array_equal(jssm[k], tssm[k].numpy()), k
    assert np.array_equal(jssm["ssm_norm"]["norm_scale"],
                          tssm["ssm_norm"]["norm_scale"].numpy())
    ulps = np.abs(jssm["A_log"].view(np.int32)
                  - tssm["A_log"].numpy().view(np.int32))
    assert ulps.max() <= 1, ulps


# -- the forward ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_match_reference(arch):
    jc, tc = _cfgs(arch)
    jb = next(JD.lm_stream(jc.vocab, BATCH, SEQ))[1]
    tb = next(lm_stream(tc.vocab, BATCH, SEQ, device="cpu"))[1]

    @jax.jit
    def ref(p, tokens):
        hidden, _, _ = JT.forward(p, tokens, jc, J_SP)
        return JT.logits_from_hidden(p, hidden, jc)

    jlogits = ref(_jparams(arch), jb["tokens"])
    tp = _tparams(arch)
    hidden, cache, aux = TT.forward(tp, tb["tokens"], tc, T_SP)
    assert cache is None and float(aux) == 0.0
    logits = TT.logits_from_hidden(tp, hidden, tc)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)


def test_a_sequence_the_chunk_does_not_divide_is_refused():
    _, tc = _cfgs("mamba2-370m")
    tokens = torch.zeros((1, 24), dtype=torch.int64)   # chunk 16
    with pytest.raises(ValueError, match="not divisible by the SSD chunk"):
        TT.forward(_tparams("mamba2-370m"), tokens, tc, T_SP)


# -- training ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jmaster(arch):
    jc = _cfgs(arch)[0]
    return jax.jit(lambda k: JST.init_train_state(
        k, jc, sp_cfg=J_SP, pregen=False))(jax.random.PRNGKey(0))["master"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step0_compute_tree_bitwise_and_its_sites(arch):
    """The SSD block's in_proj and out_proj (and hymba's attention and
    FFN) are pre-generated packed operands; conv_w, A_log, D, dt_bias
    and the norms are bf16 copies."""
    jcomp = jax.jit(lambda m: JSGD.pregen_tree(m, J_SP, pack=True))(
        _jmaster(arch))
    comp = TSGD.pregen_tree(convert.params_from_jax(_np(_jmaster(arch)),
                                                    device="cpu"),
                            T_SP, pack=True)
    _assert_tree_bitwise(jcomp, comp)
    for blk in comp["blocks"]:
        for name in SITES[arch]:
            leaf = _at(blk, name)["w"]
            assert isinstance(leaf, PregenOp) and leaf.is_packed, name
        for name in NOT_SITES:
            leaf = _at(blk, name)
            assert isinstance(leaf, torch.Tensor), name
            assert leaf.dtype == torch.bfloat16, name
    sites = [t for t in TSGD.tree_leaves(comp) if isinstance(t, PregenOp)]
    assert len(sites) == len(SITES[arch]) * _cfgs(arch)[1].n_layers


def _j_run(arch, pregen):
    jc = _cfgs(arch)[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    bundle = JST.build_lm_train(jc, mesh, J_SP, J_OPT, donate=False,
                                pregen=pregen, pregen_pack=pregen,
                                use_pallas=False)
    jstate = JST.init_train_state(jax.random.PRNGKey(0), jc, sp_cfg=J_SP,
                                  pregen=pregen, pregen_pack=pregen)
    _, hist = JTR.train_steps(bundle, jstate, JD.lm_stream(
        jc.vocab, BATCH, SEQ), 3)
    return jstate, np.array([float(h["loss"]) for h in hist])


@pytest.mark.parametrize("pregen", [True, False], ids=["pregen_packed",
                                                       "legacy"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_three_steps_match_reference(arch, pregen):
    """Three BDWP steps from the reference's state: the losses."""
    tc = _cfgs(arch)[1]
    jstate, ref = _j_run(arch, pregen)
    state = convert.train_state_from_jax(_np(jstate), device="cpu", m=8)
    assert ("compute" in state) == pregen
    fn = functools.partial(TST.lm_train_step, cfg=tc, sp_cfg=T_SP,
                           opt_cfg=T_OPT, pregen=pregen, pregen_pack=pregen)
    _, thist = TTR.train_steps(fn, state, lm_stream(
        tc.vocab, BATCH, SEQ, device="cpu"), 3)
    port = np.array([float(h["loss"]) for h in thist])
    assert np.all(np.isfinite(port))
    assert np.all(np.abs(port - ref) <= np.array(LOSS_ATOL)), (port, ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_compressed_step_takes_each_pods_loss_on_its_rows(arch):
    """Two pods on one device: each pod's loss on its own rows, the
    step's the mean; no aux without experts."""
    m = check_pod_split_metrics(_cfgs(arch)[1], T_SP, T_OPT, BATCH, SEQ)
    assert float(m["aux"]) == 0