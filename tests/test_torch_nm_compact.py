"""Port parity for the ``nm_compact`` kernel module (SORE).

* ``ref_nm_compact``, the port's plain version, is BITWISE equal to the
  reference's ``ops.nm_compact`` both through the Pallas kernel in
  interpret mode (``use_pallas=True``; an odd u4 compact tile goes to
  its oracle there) and through the oracle (``ref.ref_nm_compact`` and
  ``sparsity.pack_idx_u4``): values, u8 offsets and the u4 plane, odd
  Kc and heavy ties included.  Inputs are drawn without negative zeros:
  the reference's Pallas select turns a -0 survivor into +0, its oracle
  and the port keep it (ROADMAP queue 3).
* ``ops.nm_compact`` on CPU tensors runs the plain version, launches
  nothing, and writes through strided ``out`` views: a (K, F) weight
  packed along K through its transposed view equals ``nm_pack`` along
  axis 0, which is how ``pack_tree_element`` packs.
* The CUDA kernel is held to the plain version bitwise on the card
  (marked ``gpu``; ``python -m pytest -m gpu
  tests/test_torch_nm_compact.py`` there).
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.core import sparsity as JS
    from repro.kernels import ops as JO
    from repro.kernels import ref as JR
except ImportError:      # the card's machine: only the gpu test runs
    jnp = JO = JR = JS = None

from repro_torch.core import sparsity as TS
from repro_torch.kernels import nm_compact as K
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

# (n, m, R, K): even and odd Kc (1:8 at K=56 gives Kc=7, 3:8 at K=24 Kc=9)
CASES = [(2, 8, 16, 256), (2, 4, 8, 64), (1, 8, 5, 56), (3, 8, 9, 24),
         (4, 8, 8, 128), (1, 4, 4, 64), (2, 16, 8, 128)]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _x(r, k, kind, seed=0):
    """float32 inputs; ``ties`` draws few magnitudes, no negative zero."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((r, k)).astype(np.float32)
    v = rng.integers(1, 4, (r, k)).astype(np.float32)
    v[rng.random((r, k)) < 0.25] = 0.0
    return v * rng.choice([-1.0, 1.0], (r, k)).astype(np.float32) + 0.0


@pytest.mark.parametrize("n,m,r,k", CASES)
@pytest.mark.parametrize("idx_bits", [8, 4])
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_bitwise(n, m, r, k, idx_bits, kind, dtype):
    x = _x(r, k, kind)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    vt, it = TR.ref_nm_compact(xt, n, m, idx_bits)
    kc = k // m * n
    assert tuple(vt.shape) == (r, kc) and vt.dtype == xt.dtype
    assert tuple(it.shape) == (r, (kc + 1) // 2 if idx_bits == 4 else kc)
    vj, ij = JO.nm_compact(xj, n, m, use_pallas=True, idx_bits=idx_bits)
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    vo, io = JR.ref_nm_compact(xj, n, m)
    if idx_bits == 4:
        io = JS.pack_idx_u4(io, axis=-1)
    np.testing.assert_array_equal(_bits(vt), _bits(vo))
    np.testing.assert_array_equal(it.numpy(), np.asarray(io))


def test_plain_keeps_negative_zero():
    """A -0 survivor stays -0 (the oracle's gather; not the Pallas select)."""
    x = torch.tensor([[-0.0, 0.0, 0.0, 0.0]])
    vals, idx = TR.ref_nm_compact(x, 1, 4)
    assert idx.tolist() == [[0]]
    assert torch.signbit(vals).tolist() == [[True]]


@pytest.mark.parametrize("idx_bits", [8, 4])
@pytest.mark.parametrize("n,m,k,f", [(2, 8, 64, 40), (1, 8, 56, 24),
                                     (3, 8, 24, 16)])
def test_ops_writes_strided_outputs(idx_bits, n, m, k, f):
    """The element pack's call: the (K, F) weight as its (F, K) view, vals
    and idx written into (Kc, F) tensors through their transposed views;
    equal to nm_pack (+ pack_idx_u4) along axis 0, bitwise, and no
    launch on the CPU."""
    w = torch.from_numpy(_x(k, f, "normal", seed=3)).bfloat16()
    kc = k // m * n
    vals = torch.empty((kc, f), dtype=w.dtype)
    idx = torch.empty(((kc + 1) // 2 if idx_bits == 4 else kc, f),
                      dtype=torch.uint8)
    launches = K.launches
    got = TO.nm_compact(w.t(), n, m, idx_bits, out=(vals.t(), idx.t()))
    assert K.launches == launches
    assert got[0].data_ptr() == vals.data_ptr()
    want_v, want_i = TS.nm_pack(w, n, m, axis=0)
    if idx_bits == 4:
        want_i = TS.pack_idx_u4(want_i, axis=0)
    np.testing.assert_array_equal(_bits(vals), _bits(want_v))
    np.testing.assert_array_equal(idx.numpy(), want_i.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: it never falls back to the plain
    version, and only a launch counts."""
    launches = K.launches
    with pytest.raises(ValueError, match="not CUDA"):
        K.nm_compact(torch.zeros(2, 16), 2, 8)
    assert K.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("idx_bits", [8, 4])
def test_cuda_kernel_matches_plain(idx_bits):
    """The CUDA kernel against the plain version on the card, bitwise:
    contiguous rows (odd Kc included) and a weight through its
    transposed view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, m, r, k in CASES:
        for kind in ("normal", "ties"):
            x = torch.from_numpy(_x(r, k, kind)).cuda()
            got = K.nm_compact(x, n, m, idx_bits)
            want = TR.ref_nm_compact(x, n, m, idx_bits)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    w = torch.from_numpy(_x(512, 384, "normal")).bfloat16().cuda()
    vals = torch.empty((128, 384), dtype=w.dtype, device=w.device)
    idx = torch.empty((64 if idx_bits == 4 else 128, 384), dtype=torch.uint8,
                      device=w.device)
    K.nm_compact(w.t(), 2, 8, idx_bits, out=(vals.t(), idx.t()))
    want = TR.ref_nm_compact(w.t(), 2, 8, idx_bits)
    torch.cuda.synchronize()
    assert torch.equal(vals.view(torch.int16), want[0].t().view(torch.int16))
    assert torch.equal(idx, want[1].t())
