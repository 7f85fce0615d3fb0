"""The mvue estimator of the port against the reference's
(``src/repro/optim/compress.py``: ``mvue_probs``, ``_systematic_sample``,
``mvue_compress``), on the CPU.

Given the reference's uniforms (``jax.random.uniform`` of its key, one a
group), the port's ``mvue_compress`` is bitwise the reference's, eager
and jitted (the water-filling sums and the cumsum over 8 entries round
alike here); ``mvue_probs`` is bitwise on ties, zeros, saturated
entries and groups with fewer than n nonzeros.  By statistics: over
4096 draws of a fixed gradient the mean decoded estimate lies within 5
standard errors of the gradient (plus the bf16 rounding of the wire,
2^-8 relative), each group keeps exactly n slots, and a group with at
most n nonzeros is sent exactly (bf16).  The port's draws
(``mvue_uniforms``) are a function of (step, pod) alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as JC
from repro_torch.core.sparsity import nm_unpack_n
from repro_torch.optim import compress as C

jax.config.update("jax_platform_name", "cpu")
N, M = 2, 8


def _gradient(seed, groups):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((1, groups * M)) * rng.choice(
        [1e-3, 1.0, 1e2], size=(1, groups * M))
    t[0, :16] = 0.0                                      # empty groups
    t[0, 16:24] = [0.5, 0, 0, 0, 0, 0, 0, 0]             # one nonzero
    t[0, 24:32] = [0, -2.0, 0, 0, 0, 3.0, 0, 0]          # exactly n
    t[0, 32:40] = 1.0                                    # all tied
    t[0, 40:48] = [9.0, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3]
    return t.astype(np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint16) if np.asarray(a).dtype.name == \
        "bfloat16" else np.asarray(a)


@pytest.mark.parametrize("seed", [0, 1])
def test_mvue_compress_bitwise_given_reference_uniforms(seed):
    t = _gradient(seed, 2048)
    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.random.uniform(key, (1, t.shape[1] // M, 1),
                                      dtype=jnp.float32))
    vals, idx = C.mvue_compress(torch.from_numpy(t), N, M,
                                torch.from_numpy(u[..., 0].copy()))
    for fn in (lambda x: JC.mvue_compress(x, N, M, key),
               jax.jit(lambda x: JC.mvue_compress(x, N, M, key))):
        jv, ji = fn(jnp.asarray(t))
        assert np.array_equal(_bits(jv),
                              vals.view(torch.int16).numpy().view(np.uint16))
        assert np.array_equal(np.asarray(ji), idx.numpy())


def test_mvue_probs_bitwise():
    a = np.abs(_gradient(3, 512)).reshape(1, -1, M)
    want = np.asarray(JC.mvue_probs(jnp.asarray(a), N))
    got = C.mvue_probs(torch.from_numpy(a), N).numpy()
    assert np.array_equal(want, got)
    assert np.all(got[0, :2] == 0)                          # empty groups
    np.testing.assert_array_equal(got[0, 2], np.eye(M)[0])  # one nonzero
    np.testing.assert_array_equal(got[0, 3][[1, 5]], 1.0)   # exactly n
    sums = got.sum(-1)
    nz = (a > 0).sum(-1)
    np.testing.assert_allclose(sums[nz >= N], N, rtol=1e-5)


def _decode(vals, idx, length):
    return nm_unpack_n(vals.to(torch.float32), idx, N, M).reshape(-1, length)


def test_mvue_is_unbiased_by_statistics():
    draws = 4096
    t = torch.from_numpy(_gradient(5, 64))
    rows = t.expand(draws, -1).contiguous()
    u = torch.rand((draws, t.shape[1] // M),
                   generator=torch.Generator().manual_seed(11))
    vals, idx = C.mvue_compress(rows, N, M, u)
    assert vals.shape == (draws, t.shape[1] // M * N)
    est = _decode(vals, idx, t.shape[1])
    mean, sd = est.mean(0), est.std(0)
    wire = t[0].to(torch.bfloat16).to(torch.float32)
    # the estimate of g_i is g_i / p_i with probability p_i: its standard
    # deviation |g_i| sqrt((1 - p_i) / p_i) (a rarely drawn entry's
    # sample deviation says nothing)
    p = C.mvue_probs(t.reshape(-1, M).abs(), N).reshape(-1)
    sigma = torch.where(p > 0, t[0].abs() * torch.sqrt(
        (1 - p) / torch.clamp(p, min=1e-30)), 0.0)
    tol = 5 * sigma / draws ** 0.5 + 2.0 ** -8 * t[0].abs() + 1e-30
    # the normal bound holds where an entry is drawn often enough (an
    # entry of p = 1.7e-5, beside values 1e5 times larger, is drawn 0.07
    # times in 4096 on average, and once moves the mean by 30 sigma/sqrt
    # of the draws)
    often = (draws * p >= 25) | (p == 0)
    assert float(often.float().mean()) > 0.6
    assert bool(((mean - t[0]).abs() <= tol)[often].all())
    # groups with at most n nonzeros are sent exactly, every draw
    exact = slice(0, 32)
    assert torch.equal(est[:, exact], wire[exact].expand(draws, -1))
    # the estimate is not the gradient itself: it samples
    assert float(sd[48:].max()) > 0


def test_uniforms_are_a_function_of_step_and_pod():
    tree = {"w": torch.zeros(64, 8), "blocks": [{"x": torch.zeros(4)}
                                                for _ in range(2)]}
    plan = C.plan_for(tree, 1 << 16, M)
    a = C.mvue_uniforms(plan, 3, 1, "cpu")
    assert a.shape == (plan.width // M,)
    assert torch.equal(a, C.mvue_uniforms(plan, 3, 1, "cpu"))
    assert not torch.equal(a, C.mvue_uniforms(plan, 3, 0, "cpu"))
    assert not torch.equal(a, C.mvue_uniforms(plan, 4, 1, "cpu"))
    assert bool(((a >= 0) & (a < 1)).all())
    assert C.mvue_seed(3, 1) != C.mvue_seed(1, 3)
