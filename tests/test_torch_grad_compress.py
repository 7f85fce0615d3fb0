"""Port parity: the gradient compression kernels' plain versions.

``kernels.ref.ref_grad_compress`` and ``ref_grad_decompress_mean`` are
held BITWISE to the reference's ``ops.grad_compress`` and
``ops.grad_decompress_mean``, both through its jnp path
(``use_pallas=False``, the default of the sync) and through the
interpret-mode Pallas kernels (``use_pallas=True``), for 2:8, 2:4, 1:8
and 4:16, P in {1, 2, 3, 4} pod rows, with normal draws and with heavy
ties.  The pod mean multiplies the sum by float32(1/P), as the compiled
reference does; at P = 3 a division would differ.

The inputs hold no negative zeros: the reference's Pallas compress turns
a -0 survivor into +0 and its jnp path keeps -0, so no port can match
both; the port keeps -0, as the jnp path does.

Also: the EF telescoping identity decode(vals, idx) + err' == g + err
(bitwise, fp32 and bf16 gradients); the reference's two-pod fast path
((own + peer) * 0.5 with own = t - err') equals the general mean bit for
bit; ``plan_buckets`` / ``GradCompressConfig`` refusals; the sync's
result does not depend on ``bucket_elems``; the sync calls each op once
per compressible leaf (5 on the test tree, 47 at qwen3-8b TRAIN_SYNC,
counted with the ops patched), and its result is bitwise a walk over
the reference's buckets (8, 64 and 1 << 16 elements, three steps of
residual); the launch plan of qwen3-8b TRAIN_SYNC.

The CUDA kernels against the plain versions on the card (bitwise), in
both variants (vector: aligned rows, up to whole leaves of several
million elements; scalar: any rows, and the only one "auto" picks for
rows off a whole m-group), the residual written in place, are marked
``gpu`` and skip where there is no card:
``python -m pytest -m gpu tests/test_torch_grad_compress.py``.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels import ops as JO
    from repro.optim import compress as JC
except ImportError:      # the card's machine: only the gpu tests run
    jnp = JO = JC = None

from repro_torch.configs import qwen3_8b as TC
from repro_torch.kernels import grad_compress as K
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.models import transformer_lm as TT
from repro_torch.optim import compress as C
from repro_torch.optim import sgd

NM = [(2, 8), (2, 4), (1, 8), (4, 16)]
PODS = [1, 2, 3, 4]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _inputs(rows, k, kind, seed=0):
    """(g, err) fp32: normal draws, or half-integers with many equal |g|;
    no negative zeros."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((rows, k)).astype(np.float32)
    if kind == "ties":
        g = (np.round(g * 2) / 2).astype(np.float32) + np.float32(0.0)
    err = (rng.standard_normal((rows, k)) * 0.1).astype(np.float32)
    return g, err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("pods", PODS)
@pytest.mark.parametrize("n,m", NM)
def test_plain_compress_matches_reference(n, m, pods, use_pallas):
    for kind in ("normal", "ties"):
        g, err = _inputs(pods, 64 * m, kind, seed=pods)
        ref = JO.grad_compress(jnp.asarray(g), jnp.asarray(err), n, m,
                               use_pallas=use_pallas)
        port = TR.ref_grad_compress(_t(g), _t(err), n, m)
        assert port[0].dtype == torch.bfloat16 and port[1].dtype == torch.uint8
        for name, r, p in zip(("vals", "idx", "err'"), ref, port):
            assert np.array_equal(_bits(r), _bits(p)), (kind, name)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("pods", PODS)
@pytest.mark.parametrize("n,m", NM)
def test_plain_mean_matches_reference(n, m, pods, use_pallas):
    for kind in ("normal", "ties"):
        g, err = _inputs(pods, 64 * m, kind, seed=10 + pods)
        vals, idx, _ = TR.ref_grad_compress(_t(g), _t(err), n, m)
        jv = jnp.asarray(_bits(vals)).view(jnp.bfloat16)
        ref = JO.grad_decompress_mean(jv, jnp.asarray(idx.numpy()), n, m,
                                      use_pallas=use_pallas)
        port = TR.ref_grad_decompress_mean(vals, idx, n, m)
        assert port.dtype == torch.float32 and port.shape == (64 * m,)
        assert np.array_equal(_bits(np.asarray(ref).reshape(-1)),
                              _bits(port)), kind


def test_mean_rounds_as_product_with_reciprocal():
    """At P = 3 ``sum * float32(1/3)`` and ``sum / 3`` differ somewhere;
    the plain version is the product."""
    g, err = _inputs(3, 4096, "normal", seed=7)
    vals, idx, _ = TR.ref_grad_compress(_t(g), _t(err), 2, 8)
    dense = TR.decompress_nm(vals.float(), idx, 2, 8)
    total = (dense[0] + dense[1]) + dense[2]
    got = TR.ref_grad_decompress_mean(vals, idx, 2, 8)
    assert torch.equal(got, total * TR.inv_pods(3))
    assert not torch.equal(got, total / 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m", NM)
def test_telescoping(n, m, dtype):
    g, err = _inputs(3, 32 * m, "normal", seed=3)
    g = _t(g).to(dtype)
    vals, idx, new_err = TR.ref_grad_compress(g, _t(err), n, m)
    decoded = TR.decompress_nm(vals.float(), idx, n, m)
    assert torch.equal(decoded + new_err, g.float() + _t(err))


@pytest.mark.parametrize("n,m", NM)
def test_two_pod_fast_path_equals_general_mean(n, m):
    g, err = _inputs(2, 128 * m, "normal", seed=5)
    t = _t(g) + _t(err)
    vals, idx, new_err = TR.ref_grad_compress(_t(g), _t(err), n, m)
    general = TR.ref_grad_decompress_mean(vals, idx, n, m)
    for own, peer in ((0, 1), (1, 0)):
        mine = t[own] - new_err[own]
        other = TR.ref_grad_decompress_mean(vals[peer:peer + 1],
                                            idx[peer:peer + 1], n, m)
        assert torch.equal((mine + other) * 0.5, general)


@pytest.mark.parametrize("shape", [(16, 24), (3,)])
def test_compress_leaf_matches_reference(shape):
    """Single-leaf semantics, bitwise; a ragged leaf comes back as is."""
    rng = np.random.default_rng(11)
    g, err = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    ref = JC.compress_leaf(jnp.asarray(g), jnp.asarray(err), 2, 8)
    port = C.compress_leaf(_t(g), _t(err), 2, 8)
    for r, p in zip(ref, port):
        assert np.array_equal(_bits(r), _bits(p))


def test_wire_bytes():
    cfg = C.GradCompressConfig(n=2, m=8)
    assert C.wire_bytes(1024, 3, cfg) == 128 * 2 * 3 + 12


def test_ops_dispatch_on_cpu():
    g, err = (_t(a) for a in _inputs(2, 64, "normal", seed=9))
    want = TR.ref_grad_compress(g, err, 2, 8)
    kept = err.clone()
    got = TO.grad_compress(g, kept, 2, 8)
    assert got[2] is kept
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out = torch.empty(64, dtype=torch.bfloat16)
    mean = TO.grad_decompress_mean(got[0], got[1], 2, 8, out)
    assert mean is out and torch.equal(
        out, TR.ref_grad_decompress_mean(got[0], got[1], 2, 8).bfloat16())


def test_refusals():
    with pytest.raises(ValueError, match="M-group"):
        C.GradCompressConfig(n=2, m=8, bucket_elems=20)
    with pytest.raises(ValueError, match="M-group"):
        C.plan_buckets(64, 12, 8)
    with pytest.raises(ValueError, match="M-divisible"):
        C.plan_buckets(60, 16, 8)
    with pytest.raises(ValueError, match="unknown"):
        C.GradCompressConfig(estimator="randk")
    assert C.GradCompressConfig(estimator="mvue").estimator == "mvue"
    tree = {"w": torch.zeros(2, 8, 8)}
    with pytest.raises(ValueError, match="EF residual"):
        C.cross_pod_sync(tree, torch.zeros(2, 63), C.GradCompressConfig())


def test_kernel_wrappers_refuse_cpu_tensors():
    g = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="not CUDA"):
        K.grad_compress(g, g, 2, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        K.grad_decompress_mean(g.bfloat16(), g.to(torch.uint8), 2, 8)


def _tree(pods, seed):
    """A pod-stacked master-structured tree with a ragged (3,) leaf."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return _t(rng.standard_normal((pods, *shape)).astype(np.float32))

    return {"blocks": [{"w": leaf(16, 24), "norm": leaf(8)} for _ in range(2)],
            "emb": leaf(40, 8), "bias": leaf(3)}


def _bucket_sync(grads, err, cfg):
    """The reference's bucket walk, one call of each op per bucket of
    ``plan_sync`` (the port's sync before it launched once per leaf)."""
    leaves = sgd.tree_leaves(grads)
    pods = leaves[0].shape[0]
    plan = C.plan_sync([tuple(x.shape[1:]) for x in leaves],
                       cfg.bucket_elems, cfg.m)
    outs = [x.float().mean(0).to(x.dtype) if off is None
            else torch.empty(x.shape[1:], dtype=x.dtype)
            for x, off in zip(leaves, plan.offsets)]
    for (i,), s, e in plan.chunks:   # trees without layer stacks
        col = plan.offsets[i]
        vals, idx, _ = TO.grad_compress(leaves[i].reshape(pods, -1)[:, s:e],
                                        err[:, col + s:col + e], cfg.n, cfg.m)
        TO.grad_decompress_mean(vals, idx, cfg.n, cfg.m,
                                outs[i].view(-1)[s:e])
    return outs, err


@pytest.mark.parametrize("bucket", [8, 64, 1 << 16])
def test_per_leaf_sync_equals_bucket_walk(bucket):
    """Three steps of residual: the per-leaf sync and a per-bucket walk
    give bitwise equal compressible means and residuals."""
    cfg = C.GradCompressConfig(bucket_elems=bucket)
    err_leaf, err_bucket = torch.zeros(2, 1104), torch.zeros(2, 1104)
    for step in range(3):
        tree = _tree(2, 10 + step)
        out, err_leaf = C.cross_pod_sync(tree, err_leaf, cfg)
        want, err_bucket = _bucket_sync(tree, err_bucket, cfg)
        assert torch.equal(err_leaf, err_bucket)
        for a, b, x in zip(sgd.tree_leaves(out), want, sgd.tree_leaves(tree)):
            if C.compressible_shape(tuple(x.shape[1:]), cfg.m):
                assert torch.equal(a, b)


class _CountingOps:
    """Counts ``ops.grad_compress`` / ``ops.grad_decompress_mean`` calls,
    optionally passing them through to the plain path."""

    def __init__(self, monkeypatch, through=True):
        self.calls = {"grad_compress": 0, "grad_decompress_mean": 0}
        for name in self.calls:
            real = getattr(TO, name)

            def count(*args, _name=name, _real=real):
                self.calls[_name] += 1
                if through:
                    return _real(*args)
                if _name == "grad_compress":   # shapes only (meta tensors)
                    g, err, n, m = args
                    shape = (g.shape[0], g.shape[1] // m * n)
                    return (g.new_empty(shape, dtype=torch.bfloat16),
                            g.new_empty(shape, dtype=torch.uint8), err)
                return args[-1]

            monkeypatch.setattr(TO, name, count)


def test_sync_launches_once_per_leaf(monkeypatch):
    """Five compressible leaves (two (16, 24) weights, two (8,) norms,
    one (40, 8) table; the (3,) bias rides dense): five calls of each op
    whatever the bucket size."""
    ops = _CountingOps(monkeypatch)
    for bucket in (8, 1 << 16):
        C.cross_pod_sync(_tree(2, 0), torch.zeros(2, 1104),
                         C.GradCompressConfig(bucket_elems=bucket))
    assert ops.calls == {"grad_compress": 10, "grad_decompress_mean": 10}


def test_sync_independent_of_bucket_size():
    results = []
    for bucket in (8, 64, 1 << 16):
        err = torch.zeros(2, 1104)
        for step in range(3):
            out, err = C.cross_pod_sync(_tree(2, step), err,
                                        C.GradCompressConfig(
                                            bucket_elems=bucket))
        results.append((sgd.tree_leaves(out), err))
    for leaves, err in results[1:]:
        assert torch.equal(err, results[0][1])
        for a, b in zip(leaves, results[0][0]):
            assert torch.equal(a, b)


def test_ragged_leaf_takes_dense_mean():
    tree = _tree(2, 0)
    out, _ = C.cross_pod_sync(tree, torch.zeros(2, 1104),
                              C.GradCompressConfig())
    assert torch.equal(out["bias"], (tree["bias"][0] + tree["bias"][1]) / 2)


def test_train_sync_plan(monkeypatch):
    """qwen3-8b TRAIN_SYNC: 9504 buckets each for embed and lm_head, 2948
    per layer, 1 for the final norm at 1 << 16; 145 at 1 << 24; 47
    compressible leaves (11 a layer, embed, lm_head, the final norm), so
    the sync calls each op 47 times (counted on meta tensors)."""
    cfg = TC.TRAIN_SYNC
    tree = TT.init_shell(cfg, None, device="meta")
    tree["blocks"] = list(TT.iter_blocks(cfg, None, device="meta"))
    shapes = [tuple(x.shape) for x in sgd.tree_leaves(tree)]
    plan = C.plan_sync(shapes, 1 << 16, 8)
    assert plan.n_buckets == 2 * 9504 + 4 * 2948 + 1 == 30801
    assert plan.width == C.err_state_elems(tree, 8) == 2017498112
    assert C.plan_sync(shapes, 1 << 24, 8).n_buckets == 145
    assert len(plan.leaves) == 11 * cfg.n_layers + 3 == 47
    assert sum(numel for _, _, numel in plan.leaves) == plan.width
    assert max(numel for _, _, numel in plan.leaves) == 622854144
    ops = _CountingOps(monkeypatch, through=False)
    grads = sgd.tree_map(lambda _, x: torch.empty(
        (2, *x.shape), dtype=torch.bfloat16, device="meta"), tree)
    C.cross_pod_sync(grads, torch.empty((2, plan.width), device="meta"),
                     C.GradCompressConfig())
    assert ops.calls == {"grad_compress": 47, "grad_decompress_mean": 47}


def _check_cuda_case(g, err, n, m, variant):
    """One compress (err' in place) and mean (fp32 and g's dtype) launch
    of ``variant`` against the plain versions, bitwise."""
    want = TR.ref_grad_compress(g, err, n, m)
    before = dict(K.variant_launches["grad_compress"])
    got = K.grad_compress(g, err, n, m, out_err=err, variant=variant)
    torch.cuda.synchronize()
    assert got[2] is err
    if variant != "auto":
        assert K.variant_launches["grad_compress"][variant] == \
            before[variant] + 1
    for name, a, b in zip(("vals", "idx", "err'"), got, want):
        assert np.array_equal(_bits(a), _bits(b)), (g.shape, name, variant)
    plain = TR.ref_grad_decompress_mean(got[0], got[1], n, m)
    for dt in (torch.float32, g.dtype):
        out = torch.empty(g.shape[1], dtype=dt, device=g.device)
        mean = K.grad_decompress_mean(got[0], got[1], n, m, out=out,
                                      variant=variant)
        torch.cuda.synchronize()
        assert np.array_equal(_bits(mean), _bits(plain.to(dt))), (
            g.shape, dt, variant)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["auto", "vector", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m", NM)
def test_cuda_kernels_match_plain(n, m, dtype, variant):
    """Both kernels, in each variant, against the plain versions on the
    card, bitwise, on even, ragged and strided rows, with and without
    ties, the residual written in place; every row here starts on a
    whole m-group, so the vector variant may run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for pods, k in [(2, 65536), (1, m), (3, 4096 + m), (4, 4096),
                    (2, 4096 * 129 + m)]:
        for kind in ("normal", "ties"):
            g, err = _inputs(pods, 2 * k, kind, seed=pods)
            # rows strided by 2k, as a column range of a wider tensor
            g = _t(g).cuda().to(dtype)[:, m:m + k]
            err = _t(err).cuda()[:, :k]
            _check_cuda_case(g, err, n, m, variant)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_whole_leaves(dtype):
    """A pod-stacked leaf of several million elements and its residual
    columns as the sync hands them over (2:8): the vector variant runs,
    bitwise the plain versions and the scalar variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    numel, col = 4096 * 1024 + 8 * 37, 8 * 1001
    g, err = _inputs(2, numel + col, "normal", seed=7)
    g = _t(g[:, :numel]).cuda().to(dtype)           # a whole leaf
    err = _t(err).cuda()[:, col:col + numel]       # its residual columns
    err0 = err.clone()
    before = dict(K.variant_launches["grad_compress"])
    _check_cuda_case(g, err, 2, 8, "auto")
    assert K.variant_launches["grad_compress"]["vector"] == \
        before["vector"] + 1
    vec = K.grad_compress(g, err0.clone(), 2, 8, variant="vector")
    sca = K.grad_compress(g, err0.clone(), 2, 8, variant="scalar")
    torch.cuda.synchronize()
    for a, b in zip(vec, sca):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", NM)
def test_cuda_kernels_misaligned_rows(n, m):
    """Rows that start off a whole m-group (odd element offsets, an odd
    row stride): "auto" takes the scalar variant, "vector" refuses,
    both bitwise the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k = 4096 + m
    g, err = _inputs(3, k + 3, "normal", seed=11)
    g = _t(g).cuda().to(torch.bfloat16)[:, 1:1 + k]     # off by 2 bytes
    err = _t(err).cuda()[:, 3:3 + k]                    # off by 12 bytes
    before = dict(K.variant_launches["grad_compress"])
    _check_cuda_case(g, err, n, m, "auto")
    assert K.variant_launches["grad_compress"]["scalar"] == \
        before["scalar"] + 1
    with pytest.raises(ValueError, match="vector variant"):
        K.grad_compress(g, err, n, m, variant="vector")
    out = torch.empty(k + 1, device="cuda")[1:]         # off by 4 bytes
    vals, idx, _ = K.grad_compress(g, err.clone(), n, m)
    mean = K.grad_decompress_mean(vals, idx, n, m, out=out)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(mean), _bits(
        TR.ref_grad_decompress_mean(vals, idx, n, m)))
