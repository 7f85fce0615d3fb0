"""Port parity for shared-pattern reduced-K serving (qwen3-8b SMOKE, CPU).

The reference's path is ``bdwp.pack_tree_shared`` (one N:M row pattern
per weight, ``shared_ff_pack``) -> ``SharedOp(vals, idx)`` ->
``nm_apply`` -> ``_shared_serve`` (gather + an M/N-times-shorter
matmul), which is ``kernels.ops.nm_spmm_shared`` with one output tile.

* Selection is exact: ``nm_mask_shared``, ``sparsify(granularity=
  "shared")``, ``ops.pack_shared`` (vals and rows), ``shared_ff_pack``
  and ``pack_tree_shared`` on converted params are BITWISE equal to the
  reference's.  The scores are fp32 sums of |w| over a tile or a row;
  both frameworks sum them in their own order, so equal patterns hold
  wherever no two rows of a group tie to the last bit (these seeds).
* ``ref_nm_spmm_shared`` (the plain version the CPU path runs) sums the
  same fp32 products as the reference's ``ops.nm_spmm_shared``
  (interpret-mode Pallas and the oracle) in another order:
  |port - ref| <= 1e-5 * (|act| @ |W|), as for ``nm_spmm``.
* Shared-packed SMOKE prefill and per-slot decode logits agree with the
  reference's ``lm_prefill_step``/``lm_decode_step`` on its own
  ``pack_tree_shared`` tree within ``test_torch_model.py``'s ATOL = 2e-2
  (its docstring says why), and the greedy tokens are equal.
* ``pack_tree_element`` is unchanged: it now packs through
  ``ops.nm_compact`` and still equals ``nm_pack`` + ``pack_idx_u4``.
* The CUDA kernel is held to the plain version on the card (marked
  ``gpu``; the card's machine has no JAX, so there ``python -m pytest -m
  gpu tests/test_torch_shared.py`` runs only that test).
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.core import bdwp as JB
    from repro.core import sparsity as JS
    from repro.kernels import ops as JO
    from repro.models import transformer_lm as JT
    from repro.train import step as JST

    jax.config.update("jax_platform_name", "cpu")
    J_CFG = get_arch("qwen3-8b").smoke
    J_SP = JS.SparsityConfig(n=2, m=8, method="bdwp", granularity="shared")
except ImportError:      # the card's machine: only the gpu test runs
    jax = None

from repro_torch import convert
from repro_torch.configs import qwen3_8b as TC
from repro_torch.core import bdwp as TB
from repro_torch.core import operand as O
from repro_torch.core import sparsity as TS
from repro_torch.kernels import nm_spmm as KN
from repro_torch.kernels import nm_spmm_shared as K
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.models import layers as L
from repro_torch.serve.packed_params import pack_tree_element
from repro_torch.train import step as ST

T_CFG = TC.SMOKE
T_SP = TS.SparsityConfig(n=2, m=8, method="bdwp", granularity="shared")
ATOL = 2e-2
BUCKET = 12
LENS = (5, 9)
PROJ = (("attn", "q_proj"), ("attn", "k_proj"), ("attn", "v_proj"),
        ("attn", "o_proj"), ("ffn", "w_gate"), ("ffn", "w_up"),
        ("ffn", "w_down"))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _w(shape, seed=0, dtype="bfloat16"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = None if jax is None else jnp.asarray(x).astype(dtype)
    return torch.from_numpy(x).to(getattr(torch, dtype)), xj


@pytest.fixture(scope="module")
def jparams():
    p, _ = JT.init(jax.random.PRNGKey(0), J_CFG)
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")


@pytest.mark.parametrize("shape,axis,share_axis,tile", [
    ((64, 256), 0, 1, 128), ((64, 256), 0, 1, 32), ((64, 100), 0, 1, 32),
    ((96, 48), 1, 0, 16), ((2, 32, 40), 1, 2, 16)])
@pytest.mark.parametrize("n,m", [(2, 8), (1, 4)])
def test_nm_mask_shared_bitwise(shape, axis, share_axis, tile, n, m):
    """(64, 100) with tile 32 zero-pads the ragged last tile."""
    wt, wj = _w(shape, dtype="float32")
    got = TS.nm_mask_shared(wt, n, m, axis, share_axis, tile)
    want = JS.nm_mask_shared(wj, n, m, axis, share_axis, tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [0, 1])
def test_sparsify_shared_bitwise(axis):
    wt, wj = _w((64, 128), seed=1)
    tcfg = TS.SparsityConfig(n=2, m=8, granularity="shared", tile=32)
    jcfg = JS.SparsityConfig(n=2, m=8, granularity="shared", tile=32)
    got = TS.sparsify(wt, tcfg, axis=axis)
    np.testing.assert_array_equal(
        _bits(got), _bits(JS.sparsify(wj, jcfg, axis=axis)))


@pytest.mark.parametrize("k,f,tile", [(64, 256, 128), (256, 64, 32),
                                      (128, 96, 16)])
def test_pack_shared_bitwise(k, f, tile):
    """vals and rows equal the reference's, and the rows are the
    survivors of the port's own shared mask (the reference's docstring)."""
    wt, wj = _w((k, f), seed=2)
    vt, rt = TO.pack_shared(wt, 2, 8, tile=tile)
    vj, rj = JO.pack_shared(wj, 2, 8, tile=tile)
    assert rt.dtype == torch.int32 and vt.dtype == torch.bfloat16
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    mask = TS.nm_mask_shared(wt, 2, 8, axis=0, share_axis=1, tile=tile)
    for j in range(f // tile):
        np.testing.assert_array_equal(
            torch.nonzero(mask[:, j * tile])[:, 0].numpy(), rt[j].numpy())


@pytest.mark.parametrize("k,f", [(32, 16), (256, 64), (512, 24)])
def test_shared_ff_pack_bitwise(k, f):
    wt, wj = _w((k, f), seed=3)
    vt, it = TB.shared_ff_pack(wt, T_SP)
    vj, ij = JB.shared_ff_pack(wj, J_SP)
    assert it.dtype == torch.int32 and tuple(it.shape) == (k // 4,)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(vt), _bits(vj))


@pytest.mark.parametrize("idx_bits", [4, 8])
def test_packed_bytes_matches_reference(idx_bits):
    for k, f, n, m in [(4096, 12288, 2, 8), (64, 40, 1, 4)]:
        assert TO.packed_bytes(k, f, n, m, idx_bits=idx_bits) == \
            JO.packed_bytes(k, f, n, m, idx_bits=idx_bits)


def _assert_shared_close(got, want, act, vals, rows):
    scale = TR.ref_nm_spmm_shared(act.abs(), vals.abs(), rows).numpy()
    err = np.abs(got - np.asarray(want, np.float32))
    assert np.all(err <= 1e-5 * scale), float(err.max())


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("b,k,f,tile", [(4, 256, 128, 32), (8, 64, 64, 16),
                                        (3, 128, 96, 96)])
def test_nm_spmm_shared_cpu_matches_reference(use_pallas, b, k, f, tile):
    """bf16 weights, fp32 activations: XLA on the CPU has no bf16 x bf16
    -> fp32 batched dot for the reference's tiles."""
    wt, wj = _w((k, f), seed=4)
    at, aj = _w((b, k), seed=5, dtype="float32")
    vt, rt = TO.pack_shared(wt, 2, 8, tile=tile)
    vj, rj = JO.pack_shared(wj, 2, 8, tile=tile)
    launches = K.launches
    got = TO.nm_spmm_shared(at, vt, rt)
    assert K.launches == launches          # the CPU path launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, f)
    want = JO.nm_spmm_shared(aj, vj, rj, use_pallas=use_pallas)
    _assert_shared_close(got.numpy(), want, at, vt, rt)


def test_pack_tree_shared_bitwise(jparams, tparams):
    """The port's pack of the converted params equals the reference's
    pack, converted: every SharedOp's vals and int32 rows, bitwise; the
    embed, norms and lm_head stay dense."""
    jpk = JB.pack_tree_shared(jparams, J_SP)
    conv = convert.params_from_jax(jax.tree.map(np.asarray, jpk),
                                   device="cpu")
    mine = TB.pack_tree_shared(tparams, T_SP, device="cpu")
    assert isinstance(mine["lm_head"]["w"], torch.Tensor)
    assert isinstance(mine["embed"]["embed_table"], torch.Tensor)
    for layer in range(J_CFG.n_layers):
        for part, name in PROJ:
            a = mine["blocks"][layer][part][name]["w"]
            b = conv["blocks"][layer][part][name]["w"]
            assert isinstance(a, O.SharedOp) and isinstance(b, O.SharedOp)
            assert a.idx.dtype == b.idx.dtype == torch.int32
            np.testing.assert_array_equal(a.idx.numpy(), b.idx.numpy())
            np.testing.assert_array_equal(_bits(a.vals), _bits(b.vals))


def test_convert_shared_tree(jparams):
    """params_from_jax takes a pack_tree_shared tree: its stacked
    (L, Kc, F) vals and (L, Kc) idx become per-layer SharedOps, bitwise."""
    jpk = JB.pack_tree_shared(jparams, J_SP)
    conv = convert.params_from_jax(jax.tree.map(np.asarray, jpk),
                                   device="cpu")
    assert len(conv["blocks"]) == J_CFG.n_layers
    ref = jpk["blocks"]["ffn"]["w_down"]["w"]
    for layer in range(J_CFG.n_layers):
        op = conv["blocks"][layer]["ffn"]["w_down"]["w"]
        assert tuple(op.vals.shape) == tuple(ref.vals.shape[1:])
        np.testing.assert_array_equal(_bits(op.vals),
                                      _bits(np.asarray(ref.vals[layer])))
        np.testing.assert_array_equal(op.idx.numpy(),
                                      np.asarray(ref.idx[layer]))


def test_flat_packed_dicts_as_operands():
    """as_operand reads a flat {"vals", "idx"} dict with one row index per
    packed row as a SharedOp (and one of vals' rank as a byte-wide
    PackedOp); dense_apply takes such a dict as the layer itself."""
    wt, _ = _w((64, 32), seed=6)
    vals, idx = TB.shared_ff_pack(wt, T_SP)
    op = O.as_operand({"vals": vals, "idx": idx}, "w", T_SP)
    assert isinstance(op, O.SharedOp)
    pv, pi = TS.nm_pack(wt, 2, 8, axis=0)
    assert isinstance(O.as_operand({"vals": pv, "idx": pi}, "w", T_SP),
                      O.PackedOp)
    x, _ = _w((3, 64), seed=7)
    y = L.dense_apply({"vals": vals, "idx": idx}, x, "mlp/w", T_SP)
    want = L.dense_apply({"w": O.SharedOp(vals, idx)}, x, "mlp/w", T_SP)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (3, 32)
    assert torch.equal(y, want)
    dense = TS.sparsify(wt, T_SP, axis=0, share_axis=1)
    mask_dense = (x.float() @ dense.float()).bfloat16()
    np.testing.assert_allclose(y.float().numpy(), mask_dense.float().numpy(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("idx_bits", [4, 8])
def test_pack_tree_element_unchanged(tparams, idx_bits):
    """The element pack runs on ops.nm_compact now; every PackedOp is still
    nm_pack (+ pack_idx_u4) along K, bitwise, in contiguous tensors."""
    sp = TS.SparsityConfig(n=2, m=8, method="bdwp")
    packed, _ = pack_tree_element(tparams, sp, idx_bits=idx_bits,
                                  device="cpu")
    for layer in range(T_CFG.n_layers):
        for part, name in PROJ:
            op = packed["blocks"][layer][part][name]["w"]
            w = tparams["blocks"][layer][part][name]["w"]
            vals, idx = TS.nm_pack(w, 2, 8, axis=0)
            if idx_bits == 4:
                idx = TS.pack_idx_u4(idx, axis=0)
            assert op.vals.is_contiguous() and op.idx.is_contiguous()
            np.testing.assert_array_equal(_bits(op.vals), _bits(vals))
            np.testing.assert_array_equal(op.idx.numpy(), idx.numpy())


def test_shared_prefill_and_decode_logits(jparams, tparams):
    """Shared-packed serving, port vs reference, each on its own
    pack_tree_shared tree: prefill (right-padded, last_index) and two
    per-slot decode steps within ATOL, equal greedy tokens."""
    jp = JB.pack_tree_shared(jparams, J_SP)
    tp = TB.pack_tree_shared(tparams, T_SP, device="cpu")
    rng = np.random.default_rng(7)
    toks = np.zeros((len(LENS), BUCKET), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(0, J_CFG.vocab, n)
    last = np.asarray(LENS) - 1
    j_prefill = jax.jit(lambda p, t, li: JST.lm_prefill_step(
        p, {"tokens": t}, cfg=J_CFG, sp_cfg=J_SP, last_index=li))
    j_decode = jax.jit(lambda p, c, t, pos: JST.lm_decode_step(
        p, c, t, pos, cfg=J_CFG, sp_cfg=J_SP, per_slot=True))
    lj, cj = j_prefill(jp, jnp.asarray(toks), jnp.asarray(last))
    lt, ct = ST.lm_prefill_step(tp, {"tokens": torch.from_numpy(toks)},
                                cfg=T_CFG, sp_cfg=T_SP, last_index=last)
    pos = np.asarray(LENS)
    for step in range(3):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(lj)[:, -1, :J_CFG.vocab], -1)
        np.testing.assert_array_equal(
            lt[:, -1, :T_CFG.vocab].argmax(-1).numpy(), tok)
        if step == 2:
            break
        lj, cj = j_decode(jp, cj, jnp.asarray(tok[:, None], jnp.int32),
                          jnp.asarray(pos, jnp.int32))
        lt, ct = ST.lm_decode_step(tp, ct, torch.from_numpy(tok[:, None]),
                                   torch.from_numpy(pos), cfg=T_CFG,
                                   sp_cfg=T_SP)
        pos = pos + 1


SHARED_SHAPES = [(1024, 4096, 1), (1024, 1024, 1), (1024, 12288, 1),
                 (3072, 4096, 1), (1024, 128, 32), (7, 20, 1), (64, 130, 3)]
ROWS = (1, 4, 32, 128, 1024)


@pytest.mark.parametrize("kc,tf,nf", SHARED_SHAPES)
def test_shared_plan_covers_kc_once(kc, tf, nf):
    """At every B, the stages tile Kc exactly once in whole 64-row wgmma
    steps, every chunk is a whole number of stages, the splits tile the
    chunks (none empty), and the block fits in shared memory; the chunks
    do not depend on B."""
    chunks = set()
    for b in ROWS:
        pl = K.plan(b, kc, tf, nf)
        chunks.add(pl.chunk_rows)
        assert pl.tk % 64 == 0 and pl.chunk_stages * pl.tk == pl.chunk_rows
        assert (pl.n_stages - 1) * pl.tk < kc <= pl.n_stages * pl.tk
        assert pl.n_chunks == -(-kc // pl.chunk_rows) <= KN.MAX_CHUNKS
        spans = [(s * pl.chunks_per_split,
                  min(pl.n_chunks, (s + 1) * pl.chunks_per_split))
                 for s in range(pl.splits)]
        assert spans[0][0] == 0 and spans[-1][1] == pl.n_chunks
        assert all(lo < hi for lo, hi in spans)
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
        assert K.smem_bytes(pl.config, pl.tk) <= KN.MAX_SMEM
    assert len(chunks) == 1


@pytest.mark.parametrize("b", (4, 128))
def test_shared_plan_scratch_bounded(b):
    """Per-chunk scratch of the shared serve shapes (one tile, TF = F) at
    decode and prefill rows: at most 24 MiB, and none for the widest
    projections at prefill, whose grid is full."""
    for kc, tf, nf in SHARED_SHAPES[:4]:
        pl = K.plan(b, kc, tf, nf)
        assert pl.scratch_floats == (pl.n_chunks * b * nf * tf
                                     if pl.splits > 1 else 0)
        assert pl.scratch_floats * 4 <= 24 * 2**20, (kc, tf, pl)
        if b == 128 and tf == 12288:
            assert pl.splits == 1


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against the plain version on the card: the
    summation-order bound; row 0 bitwise equal at B = 1, 4, 32, 128 and
    1024 (bf16, tensor cores) and at B = 1, 4 and 37 (fp32 operands,
    CUDA cores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(4096, 1024, None, "bfloat16", "bfloat16", ROWS),
             (1024, 384, 128, "bfloat16", "bfloat16", ROWS),
             (56, 20, None, "bfloat16", "bfloat16", ROWS),
             (1024, 384, 128, "float32", "bfloat16", (1, 4, 37)),
             (56, 20, None, "bfloat16", "float32", (1, 4, 37))]
    for k, f, tile, adt, vdt, rows_b in cases:
        wt, _ = _w((k, f), seed=8, dtype=vdt)
        at, _ = _w((max(rows_b), k), seed=9, dtype=adt)
        if tile is None:
            vals, rows = TB.shared_ff_pack(wt, TS.SparsityConfig(n=1, m=8)
                                           if k == 56 else T_SP)
            vals, rows = vals[None], rows[None]
        else:
            vals, rows = TO.pack_shared(wt, 2, 8, tile=tile)
        vc, rc = vals.contiguous().cuda(), rows.contiguous().cuda()
        first = None
        for b in rows_b:
            ac = at[:b].contiguous().cuda()
            got = K.nm_spmm_shared(ac, vc, rc)
            again = K.nm_spmm_shared(ac, vc, rc)
            want = TR.ref_nm_spmm_shared(ac, vc, rc)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            first = got[:1].cpu() if first is None else first
            assert torch.equal(first, got[:1].cpu()), (k, f, tile, b)
            _assert_shared_close(got.cpu().numpy(), want.cpu().numpy(),
                                 at[:b], vals, rows)
