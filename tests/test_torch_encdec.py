"""Port parity of whisper-large-v3 (the encoder-decoder) at SMOKE size
against the JAX reference, on the CPU: the registry and configs, the
parameter counts, the converted tree and the port's own init, the
``encdec_stream`` batches, the encoder and the decoder's forward, and the
step-0 compute tree with its site set.  Training steps are in
``test_torch_encdec_train.py``, the update given the same gradients in
``test_torch_encdec_update.py``, serving in ``test_torch_encdec_serve.py``.

whisper's SMOKE is 2 encoder and 2 decoder layers of d 64, 4 heads of
16, a GELU FFN of 128 with biases, 128 source frames and 64 target
positions, vocab 512.  The reference's params are loaded with
``convert``; the same numpy-seeded batches feed both.

The arithmetic: the port keeps every bf16 rounding the reference's
source writes (the bias added to the rounded product in bf16, the GELU
op by op in bf16, each LayerNorm reading the rounded residual, the
learned positions added in bf16), and its encoder output and decoder
hidden states are bitwise the *eager* reference's (``jax.disable_jit``;
the logits within 1e-6, the head's fp32 sums in another order).  The
reference compiled by XLA on the CPU keeps excess precision (it drops
the bf16 rounding between a projection and the op that reads it), so
the compiled reference is held at ``ATOL`` = 4e-2, the limit of the
other archs' logits (measured 3.4e-2 dense and 3.2e-2 bdwp on the
test's batch, largest logit 3.7); with ``--xla_allow_excess_precision=
false`` the compiled reference is bitwise the eager one.  The compute
tree is bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import bdwp as JBDWP
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data import synthetic as JD
from repro.models import encdec as JE
from repro.optim import sgd as JSGD
from repro.train import step as JST
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch, whisper_large_v3
from repro_torch.core import bdwp
from repro_torch.core.operand import PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import encdec_stream
from repro_torch.kernels import fused_update as KF
from repro_torch.models import encdec as TE
from repro_torch.optim import sgd as TSGD

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
METHODS = ("dense", "bdwp")
ATOL = 4e-2
EAGER_LOGIT_ATOL = 1e-6
BATCH, SEQ, FRAMES = 2, 16, 32
CFG_FIELDS = ("name", "vocab", "d_model", "n_layers", "n_enc_layers",
              "n_heads", "n_kv", "head_dim", "d_ff", "max_source",
              "max_target", "remat", "pad_vocab_to", "padded_vocab")
ATTN_FIELDS = ("d_model", "n_heads", "n_kv", "head_dim", "rope_theta",
               "qk_norm", "qkv_bias", "kv_lora", "chunk_q", "chunk_kv")
# reference parameter counts (``EncDecConfig.n_params``)
N_PARAMS = {"full": 1_579_212_800, "smoke": 211_200}
# the sites of a layer, and what stays a bf16 copy
SITES = {"enc_blocks": ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                        "attn/o_proj", "ffn/w_in", "ffn/w_out"),
         "dec_blocks": ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                        "attn/o_proj", "xattn/q_proj", "xattn/k_proj",
                        "xattn/v_proj", "xattn/o_proj", "ffn/w_in",
                        "ffn/w_out")}
NOT_SITES = {"enc_blocks": ("ln1/norm_scale", "ln1/norm_bias",
                            "ln2/norm_scale", "ffn/w_in/b", "ffn/w_out/b"),
             "dec_blocks": ("ln1/norm_scale", "ln3/norm_bias",
                            "ffn/w_in/b", "ffn/w_out/b")}
# FULL under BDWP 2:8: 32 x 6 + 32 x 10 sites
FULL_SITES, FULL_SITE_ELEMS = 512, 1_468_006_400


def _sp(method):
    return (JSparsity(n=2, m=8, method=method),
            SparsityConfig(n=2, m=8, method=method))


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


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _cfgs():
    return j_get_arch(ARCH).smoke, get_arch(ARCH).smoke


@functools.lru_cache(maxsize=None)
def _jparams():
    p, _ = JE.init(jax.random.PRNGKey(0), _cfgs()[0])
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


def _tparams():
    return convert.params_from_jax(_np(_jparams()), device="cpu")


def _batches(step=0, seed=0, seq=SEQ, frames=FRAMES):
    jc, tc = _cfgs()
    jb = next(JD.encdec_stream(jc.vocab, BATCH, seq, jc.d_model,
                               enc_frames=frames, seed=seed, start=step))[1]
    tb = next(encdec_stream(tc.vocab, BATCH, seq, tc.d_model,
                            enc_frames=frames, seed=seed, start=step,
                            device="cpu"))[1]
    return jb, tb


# -- the registry and the configs ------------------------------------------


def test_registry_returns_the_arch_spec_and_configs_match_reference():
    j, t = j_get_arch(ARCH), get_arch(ARCH)
    assert ARCHS[ARCH] is t is whisper_large_v3.ARCH
    for field in ("arch_id", "family", "kind", "source", "sub_quadratic",
                  "prefix_len"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.family == "encdec" and not t.supports("long_500k")
    for jc, tc in ((j.full, t.full), (j.smoke, t.smoke)):
        assert isinstance(tc, TE.EncDecConfig)
        for field in CFG_FIELDS:
            assert getattr(tc, field) == getattr(jc, field), (jc.name, field)
        for field in ATTN_FIELDS:
            assert getattr(tc.attn_cfg(), field) == getattr(jc.attn_cfg(),
                                                            field), field
    # TRAIN: FULL itself, every width and all 32 + 32 layers
    assert whisper_large_v3.TRAIN == t.full
    assert t.full.max_target == 32768 and t.full.padded_vocab == 51968


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_n_params_equal_the_reference(size):
    t = getattr(get_arch(ARCH), size)
    assert t.n_params() == N_PARAMS[size]
    assert t.n_active_params() == N_PARAMS[size]
    if size == "smoke":
        assert _cfgs()[0].n_params() == N_PARAMS[size]


# -- the tree -----------------------------------------------------------------


def _shapes(tree):
    out = []
    TSGD.tree_map(lambda n, x: out.append((n, tuple(x.shape), x.dtype)),
                  tree)
    return sorted(out, key=lambda e: e[0])


@pytest.mark.parametrize("stack", ["enc_blocks", "dec_blocks"])
def test_converted_tree_is_per_layer(stack):
    """Each stacked (L, ...) leaf of ``enc_blocks`` / ``dec_blocks``
    becomes a list of L per-layer dicts, bitwise; the FFN's biases are
    each layer's (F,) vectors."""
    jc, tc = _cfgs()
    tp = _tparams()
    n = tc.n_enc_layers if stack == "enc_blocks" else tc.n_layers
    assert isinstance(tp[stack], list) and len(tp[stack]) == n
    want = {"enc_blocks": ["attn", "ffn", "ln1", "ln2"],
            "dec_blocks": ["attn", "ffn", "ln1", "ln2", "ln3",
                           "xattn"]}[stack]
    assert sorted(tp[stack][0]) == want
    jstack = _np(_jparams()[stack])
    for i, blk in enumerate(tp[stack]):
        for name in SITES[stack]:
            w = _at(blk, name)["w"]
            assert np.array_equal(_bits(w), _bits(_at(jstack, name)["w"][i]))
        b = blk["ffn"]["w_in"]["b"]
        assert tuple(b.shape) == (tc.d_ff,)
        assert np.array_equal(_bits(b), _bits(jstack["ffn"]["w_in"]["b"][i]))


def test_ports_own_init_has_the_references_leaves():
    """The port's init draws the converted tree's leaves, shapes and
    dtypes; zero biases and unit norm scales as the reference's; the
    learned positions N(0, 1) x 0.01."""
    tc = _cfgs()[1]
    own = TE.init(tc, device="cpu")
    conv = convert.params_from_jax(_np(JE.init(jax.random.PRNGKey(0),
                                               _cfgs()[0])[0]), device="cpu")
    assert _shapes(own) == _shapes(conv)
    blk = own["dec_blocks"][1]
    assert not blk["ffn"]["w_out"]["b"].any()
    assert torch.equal(blk["ln3"]["norm_scale"], torch.ones(tc.d_model))
    for key, n in (("pos_embed_enc", tc.max_source),
                   ("pos_embed_dec", tc.max_target)):
        assert tuple(own[key].shape) == (n, tc.d_model)
        assert 0.008 < float(own[key].std()) < 0.012, key
    again = TE.init(tc, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(TSGD.tree_leaves(own),
                                                 TSGD.tree_leaves(again)))


# -- the data ---------------------------------------------------------------


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 2)])
def test_encdec_stream_matches_reference(step, seed):
    """frames bf16 from ``PCG64([seed + 11, step])``, tokens and labels
    from ``token_batch``: the reference's bits."""
    jb, tb = _batches(step, seed)
    assert tb["frames"].dtype == torch.bfloat16
    assert tuple(tb["frames"].shape) == (BATCH, FRAMES, 64)
    assert np.array_equal(_bits(jb["frames"]), _bits(tb["frames"]))
    for key in ("tokens", "labels"):
        assert tb[key].dtype == torch.int64
        assert np.array_equal(np.asarray(jb[key]).astype(np.int64),
                              tb[key].numpy()), key


def test_encdec_stream_needs_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encdec_stream(512, 2, 8, 64)


# -- the forward --------------------------------------------------------------


def _port_forward(tp, tb, tc, sp):
    with torch.no_grad():
        enc = TE.encode(tp, tb["frames"], tc, sp)
        hidden, cache = TE.decode(tp, tb["tokens"], enc, tc, sp)
        assert cache is None
        return enc, hidden, TE.logits_from_hidden(tp, hidden, tc)


@pytest.mark.parametrize("method", METHODS)
def test_encoder_and_decoder_bitwise_the_eager_reference(method):
    """The port keeps the source's bf16 roundings: its encoder output
    and decoder hidden states equal the eager reference's bit for bit
    (bdwp: masks derived in the ops, ``MaskedOp``)."""
    jc, tc = _cfgs()
    jsp, tsp = _sp(method)
    jb, tb = _batches()
    p = _jparams()
    with jax.disable_jit():
        jenc = JE.encode(p, jb["frames"], jc, jsp)
        jhid, _ = JE.decode(p, jb["tokens"], jenc, jc, jsp)
        jlog = JE.logits_from_hidden(p, jhid, jc)
    enc, hidden, logits = _port_forward(_tparams(), tb, tc, tsp)
    assert enc.dtype == hidden.dtype == torch.bfloat16
    assert np.array_equal(_bits(jenc), _bits(enc))
    assert np.array_equal(_bits(jhid), _bits(hidden))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (BATCH, SEQ, tc.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=EAGER_LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("method", METHODS)
def test_forward_matches_the_compiled_reference(method):
    jc, tc = _cfgs()
    jsp, tsp = _sp(method)
    jb, tb = _batches()

    @jax.jit
    def ref(p, frames, tokens):
        enc = JE.encode(p, frames, jc, jsp)
        hidden, _ = JE.decode(p, tokens, enc, jc, jsp)
        return enc, JE.logits_from_hidden(p, hidden, jc)

    jenc, jlog = ref(_jparams(), jb["frames"], jb["tokens"])
    enc, _, logits = _port_forward(_tparams(), tb, tc, tsp)
    np.testing.assert_allclose(enc.float().numpy(),
                               np.asarray(jenc).astype(np.float32),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    assert (logits[..., tc.vocab:] == -1e30).all()


def test_encoder_chunks_1500_frames_in_500s():
    """``chunked_attention(chunk_kv=512)`` over FULL's 1500 frames takes
    the largest divisor at most 512, 500, as the reference does."""
    from repro.models import attention as JA

    from repro_torch.models import attention as TA

    assert TA._largest_divisor(1500, 512) == JA._largest_divisor(1500,
                                                                 512) == 500


def test_remat_changes_no_gradient():
    """The rematerialized stacks (a block's activations recomputed in
    the backward) give the gradients of the plain ones bitwise."""
    tc = _cfgs()[1]
    _, tb = _batches()
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        tp = _tparams()
        leaves = TSGD.tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        enc = TE.encode(tp, tb["frames"], cfg, _sp("bdwp")[1])
        hidden, _ = TE.decode(tp, tb["tokens"], enc, cfg, _sp("bdwp")[1])
        loss = TE.loss(tp, hidden, tb["labels"], cfg)
        grads.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# -- the compute tree -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jmaster():
    jc = _cfgs()[0]
    return jax.jit(lambda k: JST.init_train_state(
        k, jc, family="encdec", pregen=False))(jax.random.PRNGKey(0))["master"]


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_step0_compute_tree_bitwise_and_its_sites(pack):
    """Every projection of both stacks (16 names, 32 sites at SMOKE) is
    a pre-generated operand, packed with ``pack``; the embedding table,
    the positions, the norms and the biases are bf16 copies."""
    jsp, tsp = _sp("bdwp")
    jcomp = jax.jit(lambda m: JSGD.pregen_tree(m, jsp, pack=pack))(
        _jmaster())
    comp = TSGD.pregen_tree(convert.params_from_jax(_np(_jmaster()),
                                                    device="cpu"),
                            tsp, pack=pack)
    _assert_tree_bitwise(jcomp, comp)
    for stack in SITES:
        for blk in comp[stack]:
            for name in SITES[stack]:
                leaf = _at(blk, name)["w"]
                assert isinstance(leaf, PregenOp), name
                assert leaf.is_packed == pack, name
            for name in NOT_SITES[stack]:
                leaf = _at(blk, name)
                assert isinstance(leaf, torch.Tensor), name
                assert leaf.dtype == torch.bfloat16, name
    for key in ("pos_embed_enc", "pos_embed_dec"):
        assert comp[key].dtype == torch.bfloat16
    sites = [t for t in TSGD.tree_leaves(comp) if isinstance(t, PregenOp)]
    assert len(sites) == 32


def test_full_site_set_is_512_sites_in_one_fused_update_launch():
    """FULL under BDWP 2:8 (shapes only): 512 sites holding
    1,468,006,400 elements, as the reference's ``should_prune`` on its
    stacked shapes gives; every (K, F) site in one grouped fused_update
    launch, whose table (more than the by-value 256) goes through device
    memory."""
    cfg = get_arch(ARCH).full
    _, tsp = _sp("bdwp")
    meta = TE.init(cfg, device="meta")
    shapes = []
    TSGD.tree_map(lambda n, w: shapes.append(tuple(w.shape))
                  if bdwp.pregen_site(n, tuple(w.shape), tsp) else None,
                  meta)
    assert len(shapes) == FULL_SITES
    assert sum(k * f for k, f in shapes) == FULL_SITE_ELEMS < 2 ** 31
    plan = KF.plan_sites(shapes, 8)
    assert len(plan) == 1 and len(plan[0].sites) == FULL_SITES
    assert FULL_SITES > KF.PARAM_SITES
    # the reference's own policy on its stacked (L, K, F) leaves
    jsp = _sp("bdwp")[0]
    jp, _ = JE.init(jax.random.PRNGKey(0), j_get_arch(ARCH).full,
                    abstract=True)
    jsites = []

    def visit(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if JBDWP.pregen_site(name, tuple(x.shape), jsp):
            jsites.append(x.shape)

    jax.tree_util.tree_map_with_path(visit, jp)
    assert sum(s[0] for s in jsites) == FULL_SITES
    assert sum(int(np.prod(s)) for s in jsites) == FULL_SITE_ELEMS
