"""Port parity for the ``nm_spmm`` kernel module.

* ``decompress_nm`` is exact select work: BITWISE equal to the
  reference's for u8 and u4 planes (odd Kc included).
* ``ops.nm_spmm`` on CPU tensors runs the port's plain version.  It is
  held against the reference's ``ops.nm_spmm`` both through the Pallas
  kernel in interpret mode and through the jnp oracle.  Each side sums
  the same exact bf16 products (a bf16 x bf16 product is exact in fp32)
  in fp32, in another order, so the tolerance is a summation-order
  bound: |port - ref| <= 1e-5 * (|act| @ |W|), about 100x the fp32
  rounding of a sum of Kc=64 terms.
* One test runs the CUDA kernel against the plain version on the card;
  it is marked ``gpu`` and skips where there is no card.  The card's
  machine has no JAX, so the reference is imported only where it is
  installed: ``python -m pytest -m gpu tests/test_torch_nm_spmm.py``
  runs there.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels import ops as JO
    from repro.kernels.nm_spmm_shared import decompress_nm as j_decompress
except ImportError:      # the card's machine: only the gpu test runs
    jnp = JO = j_decompress = None

from repro_torch.core import sparsity as TS
from repro_torch.kernels import nm_spmm as K
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR


def _bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _packed(k, f, n, m, idx_bits, seed=0):
    """(w bf16 numpy-as-float32, vals, idx) for both packages."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, f)).astype(np.float32)
    vt, it = TS.nm_pack(torch.from_numpy(w).bfloat16(), n, m, axis=0)
    if idx_bits == 4:
        it = TS.pack_idx_u4(it, axis=0)
    if jnp is None:
        return vt, it, None, None
    vj = jnp.asarray(vt.float().numpy()).astype(jnp.bfloat16)
    ij = jnp.asarray(it.numpy())
    return vt, it, vj, ij


def _act(b, k, seed=1):
    a = np.random.default_rng(seed).standard_normal((b, k)).astype(np.float32)
    aj = None if jnp is None else jnp.asarray(a).astype(jnp.bfloat16)
    return torch.from_numpy(a).bfloat16(), aj


@pytest.mark.parametrize("n,m,k", [(2, 8, 256), (2, 4, 64), (1, 8, 56),
                                   (4, 8, 128)])
@pytest.mark.parametrize("idx_bits", [8, 4])
def test_decompress_bitwise(n, m, k, idx_bits):
    """(1, 8, 56) has Kc=7: an odd u4 plane with a padded high nibble."""
    vt, it, vj, ij = _packed(k, 24, n, m, idx_bits)
    got = TR.decompress_nm(vt, it, n, m, axis=0, idx_bits=idx_bits)
    want = j_decompress(vj, ij, n, m, axis=0, idx_bits=idx_bits)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


def _assert_spmm_close(got, want, act, vals, idx, n, m, idx_bits):
    w = TR.decompress_nm(vals, idx, n, m, axis=0, idx_bits=idx_bits)
    scale = act.float().abs() @ w.float().abs()
    err = np.abs(got - np.asarray(want, np.float32))
    assert np.all(err <= 1e-5 * scale.numpy()), float(err.max())


@pytest.mark.parametrize("idx_bits", [8, 4])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_nm_spmm_cpu_matches_reference(idx_bits, use_pallas):
    n, m, b, k, f = 2, 8, 4, 256, 128
    vt, it, vj, ij = _packed(k, f, n, m, idx_bits)
    at, aj = _act(b, k)
    launches = K.launches
    got = TO.nm_spmm(at, vt, it, n, m, idx_bits=idx_bits)
    assert K.launches == launches          # the CPU path launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, f)
    want = JO.nm_spmm(aj, vj, ij, n, m, use_pallas=use_pallas,
                      idx_bits=idx_bits)
    _assert_spmm_close(got.numpy(), want, at, vt, it, n, m, idx_bits)


def test_nm_spmm_cpu_odd_u4_plane():
    """Odd Kc with u4 indices: the reference's oracle path."""
    n, m, b, k, f = 1, 8, 3, 56, 20
    vt, it, vj, ij = _packed(k, f, n, m, 4, seed=2)
    at, aj = _act(b, k, seed=3)
    got = TO.nm_spmm(at, vt, it, n, m, idx_bits=4)
    want = JO.nm_spmm(aj, vj, ij, n, m, use_pallas=True, idx_bits=4)
    _assert_spmm_close(got.numpy(), want, at, vt, it, n, m, 4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: it never falls back to the plain
    version, and only a launch counts."""
    vt, it, _, _ = _packed(64, 16, 2, 8, 8)
    at, _ = _act(2, 64)
    launches = K.launches
    with pytest.raises(ValueError, match="not CUDA"):
        K.nm_spmm(at, vt, it, 2, 8, idx_bits=8)
    assert K.launches == launches


@pytest.mark.parametrize("k,f", [(4096, 4096), (4096, 1024), (4096, 12288),
                                 (12288, 4096), (64, 24), (56, 1000)])
def test_split_plan_covers_k_once(k, f):
    """The K split is a function of the weight shape only and its splits
    tile the m-groups exactly once, none empty."""
    m = 8
    quarter, cps, splits = K.split_plan(k, f, m)
    assert quarter % 2 == 0          # u4 rows pair up inside a quarter
    cg = 4 * quarter                 # m-groups per staged chunk
    groups = k // m
    spans = [(s * cps * cg, min(groups, (s + 1) * cps * cg))
             for s in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == groups
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("idx_bits", [8, 4])
def test_cuda_kernel_matches_plain(idx_bits):
    """The CUDA kernel against the plain version on the card: same
    summation-order bound; rows are bitwise independent of the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, m = 2, 8
    for b, k, f in [(4, 4096, 1024), (32, 4096, 4096), (3, 56 * 8, 1000)]:
        vt, it, _, _ = _packed(k, f, n, m, idx_bits)
        at, _ = _act(b, k)
        vc, ic, ac = vt.cuda(), it.cuda(), at.cuda()
        got = K.nm_spmm(ac, vc, ic, n, m, idx_bits=idx_bits)
        want = TR.ref_nm_spmm(ac, vc, ic, n, m, idx_bits=idx_bits)
        torch.cuda.synchronize()
        _assert_spmm_close(got.cpu().numpy(), want.cpu().numpy(), at, vt,
                           it, n, m, idx_bits)
        one = K.nm_spmm(ac[:1].contiguous(), vc, ic, n, m, idx_bits=idx_bits)
        assert torch.equal(one[0], got[0])
