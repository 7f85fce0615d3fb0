"""Port parity: N:M masks, packing and the u4 index plane are BITWISE
equal to the JAX reference (``repro.core.sparsity``).

Inputs are made with numpy from a seed and fed to both packages.  The
selection is exact integer/boolean work, so nothing here has a
tolerance: every mask, offset and packed value must match bit for bit,
including heavy-tie inputs, where the earliest index must win.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bdwp as JB
from repro.core import sparsity as JS
from repro_torch.core import bdwp as TB
from repro_torch.core import sparsity as TS

NM = [(2, 8), (2, 4), (1, 8), (4, 8)]


def _bits(a) -> np.ndarray:
    """Raw bits of a bf16/f32/u8/bool array or tensor, for exact compares."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _inputs(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    # heavy ties: few distinct magnitudes with random signs
    vals = rng.integers(0, 3, shape).astype(np.float32)
    return vals * rng.choice([-1.0, 1.0], shape).astype(np.float32)


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("axis", [0, -1])
def test_nm_mask_bitwise(n, m, kind, axis):
    x = _inputs((64, 256), kind)
    want = np.asarray(JS.nm_mask(jnp.asarray(x), n, m, axis=axis))
    got = TS.nm_mask(torch.from_numpy(x), n, m, axis=axis).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nm_pack_bitwise(n, m, kind, dtype):
    x = _inputs((64, 256), kind)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    vj, ij = JS.nm_pack(xj, n, m, axis=-1)
    vt, it = TS.nm_pack(xt, n, m, axis=-1)
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(_bits(it), _bits(ij))
    assert it.dtype == torch.uint8
    # unpack inverts pack exactly, and equals the reference's unpack
    dj = JS.nm_unpack_n(vj, ij, n, m, axis=-1)
    dt = TS.nm_unpack_n(vt, it, n, m, axis=-1)
    np.testing.assert_array_equal(_bits(dt), _bits(dj))


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_nm_mask_pair_bitwise(n, m, kind):
    """One selection over the FF (axis 0) and BP (axis 1) groups."""
    x = _inputs((64, 48), kind, seed=4)
    want = JS.nm_mask_pair(jnp.asarray(x), n, m, 0, 1)
    got = TS.nm_mask_pair(torch.from_numpy(x), n, m, 0, 1)
    for g, w, axis in zip(got, want, (0, 1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            g.numpy(), TS.nm_mask(torch.from_numpy(x), n, m, axis).numpy())


@pytest.mark.parametrize("n,m", NM)
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("axis", [0, -1])
def test_nm_pack_from_mask_bitwise(n, m, kind, axis):
    """Packing from a given mask equals the reference's, and nm_pack when
    the mask is x's own; a mask with short groups pads 0 at offset 0."""
    x = _inputs((64, 48), kind, seed=6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    mask = TS.nm_mask(torch.from_numpy(x), n, m, axis=axis)
    vt, it = TS.nm_pack_from_mask(xb, mask, n, m, axis=axis)
    vj, ij = JS.nm_pack_from_mask(jnp.asarray(x).astype("bfloat16"),
                                  jnp.asarray(mask.numpy()), n, m, axis=axis)
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(_bits(it), _bits(ij))
    vp, ip = TS.nm_pack(torch.from_numpy(x), n, m, axis=axis)
    np.testing.assert_array_equal(_bits(vt), _bits(vp.to(torch.bfloat16)))
    np.testing.assert_array_equal(_bits(it), _bits(ip))
    short = mask & (torch.rand(mask.shape, generator=torch.Generator()
                               .manual_seed(0)) < 0.5)
    vt, it = TS.nm_pack_from_mask(xb, short, n, m, axis=axis)
    vj, ij = JS.nm_pack_from_mask(jnp.asarray(x).astype("bfloat16"),
                                  jnp.asarray(short.numpy()), n, m, axis=axis)
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(_bits(it), _bits(ij))


def test_srste_decay_bitwise():
    x = _inputs((32, 64), "ties", seed=7)
    mask = TS.nm_mask(torch.from_numpy(x), 2, 8, axis=0)
    got = TS.srste_decay(torch.from_numpy(x), mask, 2e-4)
    want = JS.srste_decay(jnp.asarray(x), jnp.asarray(mask.numpy()), 2e-4)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n,m", NM)
def test_nm_pack_stacked_contraction_axis(n, m):
    """Stacked (L, K, F) leaves pack along axis=-2, the serving layout."""
    x = _inputs((3, 64, 48), "ties", seed=3)
    vj, ij = JS.nm_pack(jnp.asarray(x), n, m, axis=-2)
    vt, it = TS.nm_pack(torch.from_numpy(x), n, m, axis=-2)
    assert tuple(vt.shape) == (3, 64 * n // m, 48)
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(_bits(it), _bits(ij))
    uj = JS.pack_idx_u4(ij, axis=-2)
    ut = TS.pack_idx_u4(it, axis=-2)
    np.testing.assert_array_equal(_bits(ut), _bits(uj))


@pytest.mark.parametrize("kc", [1, 7, 8, 63, 64])
@pytest.mark.parametrize("axis", [0, -1])
def test_u4_plane_bitwise_and_roundtrip(kc, axis):
    """Odd Kc pads a zero high nibble; unpack trims it."""
    rng = np.random.default_rng(kc)
    shape = (kc, 5) if axis == 0 else (5, kc)
    idx = rng.integers(0, 16, shape).astype(np.uint8)
    pj = JS.pack_idx_u4(jnp.asarray(idx), axis=axis)
    pt = TS.pack_idx_u4(torch.from_numpy(idx), axis=axis)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt.shape[axis] == (kc + 1) // 2
    back = TS.unpack_idx_u4(pt, kc, axis=axis)
    np.testing.assert_array_equal(back.numpy(), idx)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JS.unpack_idx_u4(pj, kc, axis=axis)))


def test_sparsify_and_config():
    x = _inputs((32, 64), "normal", seed=5)
    cfg_j = JS.SparsityConfig(n=2, m=8, method="bdwp")
    cfg_t = TS.SparsityConfig(n=2, m=8, method="bdwp")
    want = np.asarray(JS.sparsify(jnp.asarray(x), cfg_j, axis=0))
    got = TS.sparsify(torch.from_numpy(x), cfg_t, axis=0).numpy()
    np.testing.assert_array_equal(got, want)
    xt = torch.from_numpy(x)
    assert TS.DENSE.is_dense and TS.sparsify(xt, TS.DENSE) is xt
    with pytest.raises(ValueError):
        TS.SparsityConfig(n=3, m=2)


@pytest.mark.parametrize("name,shape", [
    ("blocks/attn/q_proj", (64, 64)), ("blocks/ffn/w_down", (128, 64)),
    ("embed/embed_table", (512, 64)), ("lm_head", (64, 512)),
    ("blocks/attn/q_norm", (16,)), ("blocks/attn/k_proj", (8, 64)),
])
def test_policy_matches_reference(name, shape):
    cfg_j = JS.SparsityConfig(n=2, m=8, method="bdwp")
    cfg_t = TS.SparsityConfig(n=2, m=8, method="bdwp")
    assert TB.should_prune(name, shape, cfg_t) == JB.should_prune(name, shape, cfg_j)
    assert TB.serve_packable(name, shape, cfg_t) == JB.serve_packable(name, shape, cfg_j)
    assert TB.ff_group_axis(shape) == JB.ff_group_axis(shape)
    assert TB.bp_group_axis(shape) == JB.bp_group_axis(shape)
    assert TB.pick_cfg(name, shape, cfg_t).is_dense == \
        JB.pick_cfg(name, shape, cfg_j).is_dense
    assert TB.decays(name, shape, cfg_t) == JB.decays(name, shape, cfg_j)
    # bare-array (MoE) sites too: the reference's default bare=True
    for leaf in (name, name + "/w"):
        assert TB.pregen_site(leaf, shape, cfg_t) == \
            JB.pregen_site(leaf, shape, cfg_j)
