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


# ---- the two kernel variants ------------------------------------------

# qwen3-8b's seven projections (K, F), packed along K as the element pack
# packs them
QWEN3_8B = {"q_proj": (4096, 4096), "k_proj": (4096, 1024),
            "v_proj": (4096, 1024), "o_proj": (4096, 4096),
            "w_gate": (4096, 12288), "w_up": (4096, 12288),
            "w_down": (12288, 4096)}


def _weight_views(f):
    """(x, vals, idx) of ``vector_ok`` for a contiguous (K, F) weight read
    as its (F, K) view, written into contiguous (Kc, F) vals and idx
    planes through their transposed views: each (pointer, R stride, K
    stride); allocations 512-byte aligned."""
    return (0, 1, f), (512, 1, f), (1024, 1, f)


@pytest.mark.parametrize("name", QWEN3_8B)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_vector_rule_takes_qwen3_weights(name, itemsize):
    """Every qwen3-8b weight's view as the element pack hands it over
    (bf16, and fp32 too) may take the vector variant at every n <= 4;
    the u8 and the u4 index planes alike have K stride F."""
    f = QWEN3_8B[name][1]
    for n in (1, 2, 3, 4):
        assert K.vector_ok(f, itemsize, n, *_weight_views(f))


@pytest.mark.parametrize("case", [
    "F=1000", "F=1004", "view off by one column",
    "row stride off by one column", "score rows", "contiguous outputs",
    "vals off 8 bytes", "idx K stride 8 bytes", "n=5"])
def test_vector_rule_refuses(case):
    """The vector variant's rule refuses: F = 1000 (its u8/u4 index
    plane's K stride, 1000 bytes, is off 16), F = 1004 (not a whole
    number of 16-byte chunks), a view whose pointer or row stride is off
    by one bf16 column, contiguous (R, K) score rows, contiguous (R, Kc)
    outputs, a vals pointer off 16 bytes, an idx K stride that is not a
    multiple of 16 bytes, n > 4."""
    rows = f = 4096
    n = 2
    x, vals, idx = _weight_views(f)
    if case in ("F=1000", "F=1004"):
        rows = int(case[2:])
        x, vals, idx = _weight_views(rows)
    elif case == "view off by one column":       # w.flatten()[1:].view
        x = (x[0] + 2, 1, f)
    elif case == "row stride off by one column":  # w[:, 1:] of (K, F + 1)
        x = (x[0] + 2, 1, f + 1)
    elif case == "score rows":                    # (nf, K) contiguous
        rows = 32
        x, vals, idx = (0, 4096, 1), (512, 1024, 1), (1024, 1024, 1)
    elif case == "contiguous outputs":            # out=None
        vals, idx = (512, 1024, 1), (1024, 1024, 1)
    elif case == "vals off 8 bytes":
        vals = (vals[0] + 8, 1, f)
    elif case == "idx K stride 8 bytes":   # a column range of a wider one
        idx = (idx[0], 1, f + 8)
    else:
        n = 5
    assert not K.vector_ok(rows, 2, n, x, vals, idx)


def test_pick_variant_on_cpu_tensors():
    """``pick_variant`` reads only shapes, strides and pointers: an
    aligned transposed weight view goes to the vector variant under
    "auto" (to the scalar one at n = 5); a view off by one column goes
    to the scalar one, and asking for "vector" there raises; an unknown
    variant raises."""
    w = torch.zeros((65, 48), dtype=torch.bfloat16)
    vals = torch.empty((16, 48), dtype=w.dtype)
    idx = torch.empty((8, 48), dtype=torch.uint8)
    good = w[:64].t()
    assert K.pick_variant("auto", good, vals.t(), idx.t(), 2) == "vector"
    assert K.pick_variant("scalar", good, vals.t(), idx.t(), 2) == "scalar"
    assert K.pick_variant("auto", good, vals.t(), idx.t(), 5) == "scalar"
    off = w.flatten()[1:1 + 64 * 48].view(64, 48).t()
    assert K.pick_variant("auto", off, vals.t(), idx.t(), 2) == "scalar"
    with pytest.raises(ValueError, match="vector variant"):
        K.pick_variant("vector", off, vals.t(), idx.t(), 2)
    rows = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="vector variant"):
        K.pick_variant("vector", rows, *TR.ref_nm_compact(rows, 2, 8), 2)
    with pytest.raises(ValueError, match="variant must be"):
        K.pick_variant("wide", good, vals.t(), idx.t(), 2)


_INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _expected(x, n, m, idx_bits):
    """The plain version's (vals bits, idx) for (R, K) ``x``; a NaN
    survivor's bits are x's own at its offset (the values are copied:
    the plain gather of a bf16 NaN need not keep its payload)."""
    vals, idx = TR.ref_nm_compact(x, n, m, idx_bits)
    _, offs = TR.ref_nm_compact(x, n, m, 8)
    r, k = x.shape
    raw = x.contiguous().view(_INT[x.dtype]).reshape(r, k // m, m)
    copied = torch.gather(raw, -1, offs.reshape(r, k // m, n).long())
    return (torch.where(torch.isnan(vals), copied.reshape(r, -1),
                        vals.view(_INT[x.dtype])), idx)


def _weight(k, f, kind, dtype, seed=0):
    """A (K, F) CUDA weight: normal draws; "ties" small integers with -0
    for every zero; "nan" that plus NaNs of random payload and sign
    (many groups hold two) and infinities."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        w = torch.from_numpy(rng.standard_normal((k, f)).astype(np.float32))
        return w.to(dtype).cuda()
    w = rng.integers(-2, 3, (k, f)).astype(np.float32)
    w[w == 0] = -0.0
    if kind == "nan":
        w[rng.random((k, f)) < 0.05] = np.inf
        w[rng.random((k, f)) < 0.05] = -np.inf
    w = torch.from_numpy(w).to(dtype)
    if kind == "nan":
        bits = w.view(_INT[dtype])
        top = 16 if dtype == torch.bfloat16 else 32
        pay = torch.from_numpy(rng.integers(1, 64, (k, f))).to(bits.dtype)
        sign = torch.from_numpy(rng.random((k, f)) < 0.5)
        nan = (pay | (0x7f80 << (top - 16))).to(bits.dtype)
        nan = torch.where(sign, nan | torch.tensor(-1 << (top - 1),
                                                   dtype=bits.dtype), nan)
        at = torch.from_numpy(rng.random((k, f)) < 0.15)
        bits[at] = nan[at]
    return w.cuda()


def _pack_view(w, n, m, idx_bits, variant, x=None):
    """nm_compact of the (K, F) weight ``w`` (or the (F, K) view ``x``)
    into (Kc, F) vals and idx through their transposed views; returns
    (vals (F, Kc) bits, idx (F, *)) and the variant that ran."""
    x = w.t() if x is None else x
    f, k = x.shape
    kc = k // m * n
    vals = torch.empty((kc, f), dtype=x.dtype, device=x.device)
    idx = torch.empty(((kc + 1) // 2 if idx_bits == 4 else kc, f),
                      dtype=torch.uint8, device=x.device)
    before = dict(K.variant_launches)
    K.nm_compact(x, n, m, idx_bits, out=(vals.t(), idx.t()), variant=variant)
    torch.cuda.synchronize()
    ran = [v for v in K.VARIANTS if K.variant_launches[v] != before[v]]
    assert len(ran) == 1
    return vals.t().contiguous().view(_INT[x.dtype]), idx.t(), ran[0]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["auto", "vector", "scalar"])
@pytest.mark.parametrize("idx_bits", [8, 4])
def test_cuda_variants_match_plain(variant, idx_bits):
    """Each variant against the plain version on the card, bitwise: every
    CASES pattern as a strided (K, F) weight (F = 16 R, bf16 and fp32,
    normal draws and -0 ties; "auto" takes the vector variant), and as
    contiguous rows (the scalar variant only: "auto" takes it, "vector"
    raises)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, m, r, k in CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for kind in ("normal", "ties"):
                w = _weight(k, 16 * r, kind, dtype, seed=r)
                vb, ib, ran = _pack_view(w, n, m, idx_bits, variant)
                assert ran == ("vector" if variant == "auto" else variant)
                want = _expected(w.t(), n, m, idx_bits)
                assert torch.equal(vb, want[0]), (n, m, k, dtype, kind)
                assert torch.equal(ib, want[1]), (n, m, k, dtype, kind)
        x = torch.from_numpy(_x(r, k, "ties")).cuda()
        if variant == "vector":
            with pytest.raises(ValueError, match="vector variant"):
                K.nm_compact(x, n, m, idx_bits, variant=variant)
            continue
        before = K.variant_launches["scalar"]
        got = K.nm_compact(x, n, m, idx_bits, variant=variant)
        want = TR.ref_nm_compact(x, n, m, idx_bits)
        torch.cuda.synchronize()
        assert K.variant_launches["scalar"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,k,f", [(1, 8, 8 * 61, 256), (3, 8, 8 * 33, 512),
                                     (2, 8, 512, 4096), (4, 16, 512, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_vector_odd_n_ties_nans(n, m, k, f, dtype):
    """Strided weights with odd n and u4 (a thread pairs two groups, an
    odd group count leaves the last byte's high nibble 0), -0 ties and
    groups with two NaNs: both variants bitwise the plain version, the
    NaN payloads copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kind in ("ties", "nan"):
        w = _weight(k, f, kind, dtype, seed=k)
        want = _expected(w.t(), n, m, 4)
        for variant in ("vector", "scalar"):
            vb, ib, _ = _pack_view(w, n, m, 4, variant)
            assert torch.equal(vb, want[0]), (kind, variant)
            assert torch.equal(ib, want[1]), (kind, variant)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["F=1000", "view off by one column",
                                  "row stride off by one column"])
def test_cuda_misaligned_views_take_scalar(case):
    """Views the vector variant may not take: "auto" launches the scalar
    variant, bitwise the plain version; "vector" raises and launches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, f = 512, 1000 if case == "F=1000" else 512
    w = _weight(k, f + 1, "normal", torch.bfloat16, seed=5)
    if case == "F=1000":
        x = w[:, :f].t()          # row stride f + 1, f % 16 != 0
    elif case == "view off by one column":
        x = w.flatten()[1:1 + k * f].view(k, f).t()
    else:
        x = w[:, 1:].t()
    vb, ib, ran = _pack_view(None, 2, 8, 4, "auto", x=x)
    assert ran == "scalar"
    want = _expected(x, 2, 8, 4)
    assert torch.equal(vb, want[0]) and torch.equal(ib, want[1])
    count = K.launches
    with pytest.raises(ValueError, match="vector variant"):
        _pack_view(None, 2, 8, 4, "vector", x=x)
    assert K.launches == count
