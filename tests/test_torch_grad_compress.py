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
result does not depend on ``bucket_elems``; the launch plan of qwen3-8b
TRAIN_SYNC.

The CUDA kernels against the plain versions on the card (bitwise) are
marked ``gpu`` and skip where there is no card:
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        C.GradCompressConfig(estimator="mvue")
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


def test_train_sync_plan():
    """qwen3-8b TRAIN_SYNC: 9504 buckets each for embed and lm_head, 2948
    per layer, 1 for the final norm at 1 << 16; 145 at 1 << 24."""
    cfg = TC.TRAIN_SYNC
    tree = TT.init_shell(cfg, None, device="meta")
    tree["blocks"] = list(TT.iter_blocks(cfg, None, device="meta"))
    shapes = [tuple(x.shape) for x in sgd.tree_leaves(tree)]
    plan = C.plan_sync(shapes, 1 << 16, 8)
    assert plan.n_buckets == 2 * 9504 + 4 * 2948 + 1 == 30801
    assert plan.width == C.err_state_elems(tree, 8) == 2017498112
    assert C.plan_sync(shapes, 1 << 24, 8).n_buckets == 145


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m", NM)
def test_cuda_kernels_match_plain(n, m, dtype):
    """Both kernels against the plain versions on the card, bitwise, on
    even, ragged and strided rows, with and without ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for pods, k in [(2, 65536), (1, m), (3, 4096 + m), (4, 4096)]:
        for kind in ("normal", "ties"):
            g, err = _inputs(pods, 2 * k, kind, seed=pods)
            # rows strided by 2k, as a bucket of a wider leaf is
            g = _t(g).cuda().to(dtype)[:, m:m + k]
            err = _t(err).cuda()[:, :k]
            want = TR.ref_grad_compress(g, err, n, m)
            got = K.grad_compress(g, err, n, m, out_err=err)   # in place
            torch.cuda.synchronize()
            assert got[2] is err
            for name, a, b in zip(("vals", "idx", "err'"), got, want):
                assert np.array_equal(_bits(a), _bits(b)), (pods, k, name)
            mean = K.grad_decompress_mean(got[0], got[1], n, m)
            plain = TR.ref_grad_decompress_mean(got[0], got[1], n, m)
            torch.cuda.synchronize()
            assert np.array_equal(_bits(mean), _bits(plain)), (pods, k)
