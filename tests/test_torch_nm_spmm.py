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


QWEN_PROJ = [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)]
ROWS = (1, 4, 32, 128, 1024, 2048)


PLAN_SHAPES = [(k, f, n, m) for k, f in QWEN_PROJ + [
    (64, 24), (56, 1000), (512, 130), (8, 8), (48, 20), (36, 40)]
    for n, m in [(2, 8), (1, 8), (3, 8), (4, 16), (1, 4), (2, 6)]
    if k % m == 0]


def _chains(pl, k):
    """Per chunk, the dense K columns of each k16 tensor-core product
    the plan issues, in order (padding past sk or K left out): what
    decides an output's bits."""
    chains = []
    for c in range(pl.n_chunks):
        steps = []
        for s in range(c * pl.chunk_stages,
                       min(pl.n_stages, (c + 1) * pl.chunk_stages)):
            for j in range(0, pl.tk, 16):
                cols = tuple(s * pl.sk + x for x in range(j, j + 16)
                             if x < pl.sk and s * pl.sk + x < k)
                if cols:
                    steps.append(cols)
        chains.append(steps)
    return chains


@pytest.mark.parametrize("k,f,n,m", PLAN_SHAPES)
def test_split_plan_covers_k_once(k, f, n, m):
    """At every B, the stages tile the m-groups exactly once, every chunk
    is a whole number of stages, the splits tile the chunks (none empty),
    the chunks' k16 products cover K once in order, and the block fits in
    the card's shared memory."""
    groups = k // m
    for b in ROWS:
        pl = K.plan(b, k, f, n, m)
        assert pl.sk == pl.gs * m and pl.cr == pl.gs * n
        assert pl.tk % 64 == 0 and pl.sk <= pl.tk
        assert (pl.n_stages - 1) * pl.gs < groups <= pl.n_stages * pl.gs
        assert pl.chunk_stages * pl.gs == pl.chunk_groups
        assert pl.n_chunks == -(-groups // pl.chunk_groups)
        spans = [(s * pl.chunks_per_split,
                  min(pl.n_chunks, (s + 1) * pl.chunks_per_split))
                 for s in range(pl.splits)]
        assert spans[0][0] == 0 and spans[-1][1] == pl.n_chunks
        assert all(lo < hi for lo, hi in spans)
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
        assert K.smem_bytes(pl.config, pl.tk, pl.cr) <= K.MAX_SMEM
        cols = [c for chain in _chains(pl, k) for step in chain
                for c in step]
        assert cols == list(range(k))


@pytest.mark.parametrize("k,f,n,m", PLAN_SHAPES)
def test_plan_chunks_independent_of_rows(k, f, n, m):
    """Batch independence: whatever tile configuration, stage width and
    split B picks, the chunks are the same and each chunk's k16 products
    run over the same dense columns in the same order."""
    want = _chains(K.plan(1, k, f, n, m), k)
    pl1 = K.plan(1, k, f, n, m)
    assert pl1.chunk_groups * m >= K.CHUNK_K or pl1.n_chunks == 1
    assert pl1.n_chunks <= K.MAX_CHUNKS
    for b in ROWS[1:]:
        pl = K.plan(b, k, f, n, m)
        assert pl.chunk_groups == pl1.chunk_groups
        assert _chains(pl, k) == want


@pytest.mark.parametrize("b", ROWS)
def test_plan_scratch_bounded(b):
    """Per-chunk scratch at the qwen3-8b projections: at most 32 MiB for
    one launch at any B, and none at the training rows (B >= 1024), whose
    grid is full and folds in registers (PR 14's plan allocated up to
    1 GiB of split-K partials there)."""
    for k, f in QWEN_PROJ:
        pl = K.plan(b, k, f, 2, 8)
        assert pl.scratch_floats == (pl.n_chunks * b * f
                                     if pl.splits > 1 else 0)
        assert pl.scratch_floats * 4 <= 32 * 2**20, (k, f, pl)
        if b >= 1024:
            assert pl.splits == 1 and pl.scratch_floats == 0


@pytest.mark.parametrize("n,m,ok", [(2, 8, True), (1, 8, True),
                                    (2, 4, True), (1, 4, True),
                                    (3, 8, False), (4, 8, False),
                                    (4, 16, False), (2, 6, False)])
def test_sparse_path_eligibility(n, m, ok):
    """The 2:4 tensor-core path takes an n:m exactly when every aligned
    4-group of an m-group can hold at most 2 survivors: true for any
    n <= 2 with m % 4 == 0; 3:8 packs 3 in one half."""
    assert K.sparse_ok(n, m) is ok
    if m % 4 == 0:     # random packs: the fullest aligned 4-group
        rng = np.random.default_rng(n * 100 + m)
        w = torch.from_numpy(rng.standard_normal((64 * m, 5), np.float32))
        _, idx = TS.nm_pack(w, n, m, axis=0)
        quad = idx.reshape(-1, n, 5).long() // 4
        fullest = max(int((quad == q).sum(1).max()) for q in range(m // 4))
        assert (fullest <= 2) is ok


def _gpu_cases():
    """(B, K, F, n, m, idx_bits): the training and prefill rows, ragged F,
    odd Kc with u4, and n:m off the 2:4 path."""
    cases = [(b, 4096, 1024, 2, 8, bits) for b in ROWS for bits in (8, 4)]
    cases += [(b, 512, 1000, 2, 8, 4) for b in ROWS]
    cases += [(b, 56, 20, 1, 8, 4) for b in ROWS]
    cases += [(b, 512, 130, 4, 16, 4) for b in (1, 4, 128)]
    cases += [(b, 768, 200, 3, 8, 8) for b in (1, 32, 1024)]
    return cases


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against the plain version on the card: the
    summation-order bound at every case; deterministic; row 0 bitwise
    equal across every B (and so across tile configurations and
    split-K plans)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    row0 = {}
    for b, k, f, n, m, idx_bits in _gpu_cases():
        vt, it, _, _ = _packed(k, f, n, m, idx_bits)
        at, _ = _act(max(ROWS), k)
        at = at[:b].contiguous()
        vc, ic, ac = vt.cuda(), it.cuda(), at.cuda()
        want = TR.ref_nm_spmm(ac, vc, ic, n, m, idx_bits=idx_bits)
        got = K.nm_spmm(ac, vc, ic, n, m, idx_bits=idx_bits)
        again = K.nm_spmm(ac, vc, ic, n, m, idx_bits=idx_bits)
        torch.cuda.synchronize()
        _assert_spmm_close(got.cpu().numpy(), want.cpu().numpy(), at, vt,
                           it, n, m, idx_bits)
        assert torch.equal(got, again)
        key = (k, f, n, m, idx_bits)
        first = row0.setdefault(key, got[0].cpu())
        assert torch.equal(first, got[0].cpu()), (b, key)


@pytest.mark.gpu
def test_cuda_plan_layout_matches_source():
    """The wrapper's shared-memory formula is the source's Layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lib = K._library()
    for config in range(len(K.CONFIGS)):
        bm, bn, _ = K.tile(config)
        for tk, cr in [(64, 16), (128, 32), (128, 22), (128, 128)]:
            assert lib.nm_spmm_smem_bytes(bm, bn, tk, cr) == \
                K.smem_bytes(config, tk, cr)


@pytest.mark.gpu
@pytest.mark.parametrize("e,b,k,f,n,m,idx_bits", [
    (32, 1280, 1024, 512, 2, 8, 8),    # granite's expert stacks (TMA)
    (4, 8, 4096, 512, 2, 8, 4),        # decode rows: split-K, u4
    (3, 37, 56, 20, 1, 8, 4),          # odd Kc u4, F % 16: plain loads
    (5, 300, 768, 200, 3, 8, 8)])      # 3:8, ragged F: plain loads
def test_cuda_stacked_launch_is_each_experts_2d_launch(e, b, k, f, n, m,
                                                       idx_bits):
    """One launch over an (E, B, K) x (E, Kc, F) stack: every expert's
    slab bitwise the 2-D launch on that expert (the TMA and the
    plain-load paths, split and unsplit), and within the summation-order
    bound of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    packs = [_packed(k, f, n, m, idx_bits, seed=j)[:2] for j in range(e)]
    vals = torch.stack([v for v, _ in packs]).cuda()
    idx = torch.stack([i for _, i in packs]).cuda()
    act = torch.stack([_act(b, k, seed=j + 1)[0] for j in range(e)]).cuda()
    got = K.nm_spmm(act, vals, idx, n, m, idx_bits=idx_bits)
    assert got.shape == (e, b, f)
    for j in range(e):
        assert torch.equal(got[j], K.nm_spmm(act[j], vals[j], idx[j], n, m,
                                             idx_bits=idx_bits)), j
    want = TR.ref_nm_spmm(act, vals, idx, n, m, idx_bits=idx_bits)
    dense = TR.decompress_nm(vals, idx, n, m, axis=-2, idx_bits=idx_bits)
    scale = torch.bmm(act.float().abs(), dense.float().abs())
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
