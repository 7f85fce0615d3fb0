"""Port parity of the Mamba-2 SSD block (``models/ssm.py``) and of the
mamba and hybrid layers against the JAX reference, on the CPU, at
mamba2's SMOKE widths (d_model 64, d_inner 128, 8 heads of 16, state
16, a 4-tap conv, chunks of 16) with bf16 weights from the reference's
init:

* ``_causal_conv`` with and without an incoming conv state: output and
  the new state bitwise the compiled reference's;
* ``_ssd_chunked`` against the compiled reference (``ATOL_SSD``
  relative to the output's largest) and against the sequential fp32
  recurrence of ``tests/test_packed_serve.py`` (bf16 factors: 0.01 of
  the output scale, the port's deviation the reference's);
* ``ssm_apply``: prefill without a cache (bitwise the compiled
  reference's output on these inputs), prefill with one (the fp32 state
  within ``STATE_ATOL``, the conv window bitwise; an incoming conv state
  ignored), and decode steps from it (outputs within one bf16 ulp at
  their scale, state within ``STATE_ATOL``);
* one mamba and one hybrid block (windowed attention and the SSD block
  mean-combined, the FFN after ln2 on the fp32 x + mix) bitwise the
  compiled reference's: the port rounds where the compiled reference
  rounds (the SSD gate's product reaches the norm in fp32, unrounded);
* the deterministic leaves, the chunk refusal, the caches' dtypes, the
  profiler ranges.

The compiled reference is held, not the eager one: run eagerly, the
reference rounds the gate's product to bf16 before the norm and lands
half its bf16 outputs an ulp away from its own compiled form.

Tolerances: ``ATOL_SSD`` = 2e-5 of the largest |y| (fp32 sums in other
orders, and exp's last ulp, as two libms give it, flips the bf16
rounding of a decay factor now and then: measured 4.4e-6);
``STATE_ATOL`` = 1e-5 absolute on states of magnitude below 1
(measured 1.2e-7); decode outputs within 2^-7 of their largest |value|
(one bf16 ulp).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import ssm as JS
from repro.models import transformer_lm as JT
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer_lm as TT

jax.config.update("jax_platform_name", "cpu")

J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
ATOL_SSD = 2e-5
STATE_ATOL = 1e-5
B, S = 2, 32


def _t(a) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(a), "cpu")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _cfgs(arch="mamba2-370m"):
    return j_get_arch(arch).smoke, get_arch(arch).smoke


@functools.lru_cache(maxsize=None)
def _jblock(arch="mamba2-370m"):
    """Layer 0's params of the reference's bf16 SMOKE init."""
    p, _ = JT.init(jax.random.PRNGKey(0), _cfgs(arch)[0])
    p = jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)
    return jax.tree.map(lambda a: a[0], p["blocks"])


def _tblock(arch="mamba2-370m"):
    return convert.params_from_jax(jax.tree.map(np.asarray, _jblock(arch)),
                                   device="cpu")


def _x(seed=0, s=S, d=64):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((B, s, d)), jnp.bfloat16)


# -- the pieces -------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bitwise(with_state):
    """The sum of K bf16 products in tap order, its SiLU and the new
    window: bitwise, jitted and eager reference alike."""
    rng = np.random.default_rng(1)
    c = _cfgs()[0].ssm_cfg().conv_dim
    xbc = jnp.asarray(rng.standard_normal((B, 1 if with_state else S, c)),
                      jnp.bfloat16)
    w = _jblock()["ssm"]["conv_w"]
    state = (jnp.asarray(rng.standard_normal((B, 3, c)), jnp.float32)
             .astype(jnp.bfloat16).astype(jnp.float32)
             if with_state else None)
    for fn in (JS._causal_conv, jax.jit(JS._causal_conv)):
        jo, jst = fn(xbc, w, state)
        to, tst = TS._causal_conv(_t(xbc), _t(w),
                                  None if state is None else _t(state))
        assert np.array_equal(_bits(jo), _bits(to))
        assert np.array_equal(_bits(jst), _bits(tst))
        assert to.dtype == tst.dtype == torch.bfloat16


def _ssd_inputs(seed=2, s=64, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, s, h, p)), jnp.float32)
    dt = jax.nn.softplus(jnp.asarray(rng.standard_normal((B, s, h)),
                                     jnp.float32))
    a = -jnp.exp(jnp.asarray(rng.standard_normal(h) * 0.3, jnp.bfloat16))
    bm = jnp.asarray(rng.standard_normal((B, s, n)), jnp.float32)
    cm = jnp.asarray(rng.standard_normal((B, s, n)), jnp.float32)
    d = jnp.asarray(rng.standard_normal(h), jnp.bfloat16)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_ssd_chunked_matches_reference(chunk):
    args = _ssd_inputs()
    jy, jh = jax.jit(lambda *a: JS._ssd_chunked(*a, chunk=chunk))(*args)
    ty, th = TS._ssd_chunked(*map(_t, args), chunk)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               atol=ATOL_SSD * scale, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                               atol=ATOL_SSD * scale, rtol=0)
    assert ty.dtype == th.dtype == torch.float32


def test_ssd_chunked_matches_the_sequential_recurrence():
    """The chunked scan against the fp32 recurrence h_t = exp(dt A) h +
    dt B x, y_t = C h_t + D x (``tests/test_packed_serve.py``'s oracle,
    with its D = 0): the bf16 factors keep the port, as the reference,
    within 0.01 of the output scale (that test's 0.006 is the
    reference's own 0.0066 on these inputs), and the port's deviation is
    the reference's."""
    args = list(_ssd_inputs(seed=3))
    args[5] = jnp.zeros_like(args[5])
    jy, _ = jax.jit(lambda *a: JS._ssd_chunked(*a, chunk=16))(*args)
    x, dt, a, bm, cm, d = map(_t, args)
    y, h_last = TS._ssd_chunked(x, dt, a, bm, cm, d, 16)
    af, df = a.to(torch.float32), d.to(torch.float32)
    h = torch.zeros((B, x.shape[2], bm.shape[-1], x.shape[3]))
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t] * af)
        upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, t], bm[:, t], x[:, t])
        h = h * da[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], h)
                  + x[:, t] * df[None, :, None])
    y_ref = torch.stack(ys, 1)
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y, y_ref, atol=0.01 * scale, rtol=0)
    torch.testing.assert_close(h_last, h, atol=0.01 * scale, rtol=0)
    ref_dev = float(np.abs(np.asarray(jy) - y_ref.numpy()).max())
    assert abs(float((y - y_ref).abs().max()) - ref_dev) <= ATOL_SSD * scale


def test_ssd_refuses_a_sequence_the_chunk_does_not_divide():
    x, dt, a, bm, cm, d = map(_t, _ssd_inputs(s=48))
    with pytest.raises(ValueError, match="not divisible"):
        TS._ssd_chunked(x, dt, a, bm, cm, d, 32)


# -- ssm_apply: prefill and decode -------------------------------------------


def test_prefill_without_a_cache_is_the_compiled_reference():
    jc, tc = _cfgs()
    x = _x()
    jy, jcache = jax.jit(lambda p, x: JS.ssm_apply(p, x, jc.ssm_cfg(), J_SP))(
        _jblock()["ssm"], x)
    ty, tcache = TS.ssm_apply(_tblock()["ssm"], _t(x), tc.ssm_cfg(), T_SP)
    assert jcache is None and tcache is None
    assert np.array_equal(_bits(jy), _bits(ty))


def test_prefill_with_a_cache_then_decode():
    """Prefill writes the state after the last position and the last 3
    conv inputs (an incoming conv state is ignored); six decode steps
    shift the window and carry the state."""
    jc, tc = _cfgs()
    jcfg, tcfg = jc.ssm_cfg(), tc.ssm_cfg()
    jp, tp = _jblock()["ssm"], _tblock()["ssm"]
    x = _x(4, s=16)
    jcache = JS.init_ssm_cache(jcfg, B)
    tcache = TS.init_ssm_cache(tcfg, B, device="cpu")
    tcache["conv"].fill_(7.0)          # ignored by a prefill
    jy, jcache = jax.jit(lambda p, x, c: JS.ssm_apply(p, x, jcfg, J_SP,
                                                      cache=c))(jp, x, jcache)
    ty, tcache = TS.ssm_apply(tp, _t(x), tcfg, T_SP, cache=tcache)
    assert np.array_equal(_bits(jy), _bits(ty))
    np.testing.assert_allclose(tcache["state"].numpy(),
                               np.asarray(jcache["state"]), atol=STATE_ATOL,
                               rtol=0)
    assert np.array_equal(tcache["conv"].numpy(), np.asarray(jcache["conv"]))
    step = jax.jit(lambda p, x, c: JS.ssm_apply(p, x, jcfg, J_SP, cache=c,
                                                decode=True))
    for i in range(6):
        x1 = _x(10 + i, s=1)
        jy, jcache = step(jp, x1, jcache)
        ty, tcache = TS.ssm_apply(tp, _t(x1), tcfg, T_SP, cache=tcache,
                                  decode=True)
        scale = float(np.abs(np.asarray(jy, np.float32)).max())
        np.testing.assert_allclose(ty.to(torch.float32).numpy(),
                                   np.asarray(jy, np.float32),
                                   atol=scale * 2 ** -7, rtol=0)
        np.testing.assert_allclose(tcache["state"].numpy(),
                                   np.asarray(jcache["state"]),
                                   atol=STATE_ATOL, rtol=0)
        assert np.array_equal(tcache["conv"].numpy(),
                              np.asarray(jcache["conv"]))
    with pytest.raises(ValueError, match="decode"):
        TS.ssm_apply(tp, _t(_x(s=2)), tcfg, T_SP, cache=tcache, decode=True)


def test_caches_and_deterministic_leaves():
    cfg = get_arch("hymba-1.5b").full.ssm_cfg()
    c = TS.init_ssm_cache(cfg, 3, device="cpu")
    assert c["state"].shape == (3, 50, 16, 64) and c["conv"].shape == (
        3, 3, 3200 + 32)
    assert c["state"].dtype == c["conv"].dtype == torch.float32
    for nh in (8, 16, 25, 32, 50, 64):
        want = np.asarray(jnp.linspace(1.0, 16.0, nh, dtype=jnp.float32))
        got = TS._linspace_1_16(nh, "cpu").numpy()
        assert np.array_equal(got, want), nh
    sp = np.asarray(jax.jit(jax.nn.softplus)(jnp.linspace(-30, 30, 1001)))
    # log1p and exp in two libms: measured 3.3e-6 relative near -30
    np.testing.assert_allclose(
        TS.softplus(torch.linspace(-30, 30, 1001)).numpy(), sp, rtol=1e-5,
        atol=0)


# -- the layers -------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_block_bitwise_the_compiled_reference(arch):
    """A mamba block (the SSD block's output added to x) and a hybrid
    block (windowed attention and the SSD block on the same ln1 output,
    0.5 (a + s), ln2 on the fp32 x + mix, the FFN)."""
    jc, tc = _cfgs(arch)
    x = _x(6)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    jy = jax.jit(lambda p, x: JT._block_apply(
        p, x, jc, J_SP, positions=pos, is_global=False)[0])(_jblock(arch), x)
    kind = tc.layer_kinds()[0]
    ty, cache, aux = TT.block_apply(
        _tblock(arch), _t(x), tc, T_SP, positions=torch.arange(S).expand(
            B, S), kind=kind, window=tc.layer_window(kind))
    assert cache is None and aux is None
    assert np.array_equal(_bits(jy), _bits(ty))


def test_profiler_ranges_split_the_ssd_block():
    _, tc = _cfgs()
    with torch.profiler.profile() as prof:
        TS.ssm_apply(_tblock()["ssm"], _t(_x(s=16)), tc.ssm_cfg(), T_SP)
    names = {e.key for e in prof.key_averages()}
    assert {"ssm/conv", "ssm/scan", "ssm/out"} <= names


def test_silu_is_spelled_out_in_bf16():
    """``layers.silu`` is ``jax.nn.silu`` as the compiled reference
    computes it, every op in bf16; swiglu is silu(gate) * up."""
    rng = np.random.default_rng(9)
    g = jnp.asarray(rng.standard_normal(4096) * 3, jnp.bfloat16)
    u = jnp.asarray(rng.standard_normal(4096), jnp.bfloat16)
    assert np.array_equal(_bits(jax.jit(jax.nn.silu)(g)),
                          _bits(TL.silu(_t(g))))
    assert np.array_equal(_bits(TL.swiglu(_t(g), _t(u))),
                          _bits(TL.silu(_t(g)) * _t(u)))
