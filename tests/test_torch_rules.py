"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``), leaf for leaf.

For all ten arch ids, SMOKE and FULL, under the TRAIN and SERVE_BATCH
rules, on meshes (pod, data, model) = (2, 2, 2), (1, 2, 1), (1, 4, 2)
and (1, 1, 8): ``nm_params_pspecs`` of the port's spec tree
(``init_specs`` over meta shapes) equals the reference's on a
``jax.sharding.AbstractMesh`` (no devices), its ``PartitionSpec``s as
tuples, a per-layer leaf's spec the reference's stacked one without its
"layer" entry.  The same holds for ``pregen_pspecs`` of the packed and
unpacked compute trees, ``serve_input_pspecs`` of each arch's cache,
``train_input_pspecs``, ``grad_sync_pspecs`` and ``parse_mesh_spec``
(the reference's ``TestMeshSpec`` cases); ``assert_nm_unsplit`` refuses
what the reference refuses (its hand-made group-splitting specs, and
u4 index planes of odd and even N).
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCHS, get_arch
from repro.core import operand as JO
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.launch import spmd as JS
from repro.models import encdec as JE
from repro.models import transformer_lm as JT
from repro.sharding import rules as JR
from repro.train import step as JST
from repro_torch.configs import get_arch as port_arch
from repro_torch.core.operand import PackedOp, PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import spmd as PS
from repro_torch.launch.mesh import Mesh
from repro_torch.models import encdec as PE
from repro_torch.models import transformer_lm as PT
from repro_torch.sharding import rules as PR
from repro_torch.train import step as PST

MESHES = [(2, 2, 2), (1, 2, 1), (1, 4, 2), (1, 1, 8)]
AXES = ("pod", "data", "model")
SPARSITY = [(2, 8, "bdwp"), (1, 4, "srste")]
RULES = [("TRAIN_RULES", "train"), ("SERVE_BATCH_RULES", "serve")]
CASES = [(a, s) for a in ARCHS for s in ("smoke", "full")]


def _meshes(shape):
    return (AbstractMesh(shape, AXES), Mesh(dict(zip(AXES, shape))))


@functools.lru_cache(maxsize=None)
def _models(arch, size):
    """(reference abstract params, reference specs, port meta params,
    port specs) of one arch at one size."""
    encdec = get_arch(arch).family == "encdec"
    jcfg = getattr(get_arch(arch), size)
    pcfg = getattr(port_arch(arch), size)
    jm, pm = (JE, PE) if encdec else (JT, PT)
    ap, specs = jm.init(jax.random.PRNGKey(0), jcfg, abstract=True)
    return ap, specs, pm.abstract_params(pcfg), pm.init_specs(pcfg)


def _leaves(tree, path=(), stacked=False):
    """(dict-key path, under a per-layer list?, node) of a port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,), stacked)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v, path, True)
    else:
        yield path, stacked, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _same(port, ref, stacked, where):
    ref = tuple(ref)
    if stacked:
        assert ref[0] in (None, "layer"), where
        ref = ref[1:]
    assert port == ref, (where, port, ref)


def _check_tree(port_tree, ref_tree):
    n = 0
    for path, stacked, node in _leaves(port_tree):
        ref = _at(ref_tree, path)
        if isinstance(node, PregenOp):
            assert isinstance(ref, JO.PregenOp), path
            for f in ("bp", "ff", "vals", "idx", "mask"):
                mine, theirs = getattr(node, f), getattr(ref, f)
                assert (mine is None) == (theirs is None), (path, f)
                if mine is not None:
                    _same(mine, theirs, stacked, (path, f))
                    n += 1
        else:
            _same(node, ref, stacked, path)
            n += 1
    return n


@pytest.mark.parametrize("arch,size", CASES)
def test_nm_params_pspecs_equal_the_reference(arch, size):
    ap, specs, pp, pspecs = _models(arch, size)
    # the logical axes themselves first
    assert _check_tree(pspecs, specs) == sum(1 for _ in _leaves(pp))
    for shape in MESHES:
        jmesh, pmesh = _meshes(shape)
        for n, m, method in SPARSITY:
            jsp, psp = JSparsity(n, m, method), SparsityConfig(n, m, method)
            for rules, _ in RULES:
                ref = JR.nm_params_pspecs(specs, getattr(JR, rules), ap,
                                          jmesh, jsp)
                mine = PR.nm_params_pspecs(pspecs, getattr(PR, rules), pp,
                                           pmesh, psp)
                _check_tree(mine, ref)
                PR.assert_nm_unsplit(mine, pp, pmesh, psp)


@pytest.mark.parametrize("arch,size", CASES)
def test_pregen_pspecs_equal_the_reference(arch, size):
    ap, specs, pp, pspecs = _models(arch, size)
    jsp, psp = JSparsity(2, 8, "bdwp"), SparsityConfig(2, 8, "bdwp")
    for pack in (False, True):
        jc = JST.abstract_compute_tree(ap, jsp, pack=pack)
        pc = PST.abstract_compute_tree(pp, psp, pack=pack)
        assert all(t.device.type == "meta" for _, _, t in _leaves(pp))
        sites = 0
        for shape in MESHES:
            jmesh, pmesh = _meshes(shape)
            jp = JR.nm_params_pspecs(specs, JR.TRAIN_RULES, ap, jmesh, jsp)
            mine_p = PR.nm_params_pspecs(pspecs, PR.TRAIN_RULES, pp, pmesh,
                                         psp)
            ref = JR.pregen_pspecs(jc, jp)
            mine = PR.pregen_pspecs(pc, mine_p)
            _check_tree(mine, ref)
            PR.assert_nm_unsplit(mine, pc, pmesh, psp)
            sites = sum(isinstance(x, PregenOp) for _, _, x in _leaves(mine))
        assert sites > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_input_pspecs_equal_the_reference(arch):
    encdec = get_arch(arch).family == "encdec"
    cfg, pcfg = get_arch(arch).smoke, port_arch(arch).smoke
    if encdec:
        jc = jax.eval_shape(lambda: JE.init_cache(cfg, 4, 32))
        pc = PE.init_cache(pcfg, 4, 32, device="meta")
    else:
        jc = jax.eval_shape(lambda: JT.init_lm_cache(cfg, 4, 32))
        pc = PT.init_lm_cache(pcfg, 4, 32, device="meta")
    for shape in MESHES + [(1, 4, 1)]:
        jmesh, pmesh = _meshes(shape)
        for long_context in (False, True):
            tok = jax.ShapeDtypeStruct((4, 1), jnp.int32)
            ref = JR.serve_input_pspecs(
                {"cache": jc, "token": tok, "tokens": tok, "enc_out": tok,
                 "pos": tok, "other": tok}, jmesh, long_context=long_context)
            mine = PR.serve_input_pspecs(
                {"cache": pc, "token": 0, "tokens": 0, "enc_out": 0,
                 "pos": 0, "other": 0}, pmesh, long_context=long_context)
            for k in ("token", "tokens", "enc_out", "pos", "other"):
                assert mine[k] == tuple(ref[k]), k
            for path, stacked, node in _leaves(mine["cache"]):
                _same(node, _at(ref["cache"], path),
                      stacked and path[0] == "layers", path)


def test_train_inputs_grad_sync_and_batch_axes_equal_the_reference():
    names = ("tokens", "labels", "frames", "prefix_embeds", "step")
    for shape, axes in [(s, AXES) for s in MESHES] + [
            ((4, 2), ("data", "model")), ((8,), ("data",))]:
        jmesh = AbstractMesh(shape, axes)
        pmesh = Mesh(dict(zip(axes, shape)))
        ref = JR.train_input_pspecs({k: None for k in names}, jmesh)
        mine = PR.train_input_pspecs({k: None for k in names}, pmesh)
        assert {k: tuple(v) for k, v in ref.items()} == mine
        assert tuple(JR.grad_sync_pspecs(jmesh)["err"]) == \
            PR.grad_sync_pspecs(pmesh)["err"]
        assert JR.batch_axes(jmesh) == PR.batch_axes(pmesh)
    assert PR.rules_for("train") == JR.rules_for("train") == JR.TRAIN_RULES
    assert PR.rules_for("serve") == JR.SERVE_BATCH_RULES
    assert PR.SERVE_LONG_RULES == JR.SERVE_LONG_RULES


@pytest.mark.parametrize("spec,n", [
    ("pod,data,model", 8), ("pod,data,model", 4), ("data,model", 1),
    ("pod=2,data=2,model=2", 8), ("pod=4,data,model", 8),
    ("pod=2,data=2", 4), ("data", 6), ("pod,data", 12)])
def test_parse_mesh_spec_equals_the_reference(spec, n):
    assert PS.parse_mesh_spec(spec, n) == JS.parse_mesh_spec(spec, n)


@pytest.mark.parametrize("spec,n", [("pod=3,data,model", 8),
                                    ("pod=2,data=2", 8)])
def test_parse_mesh_spec_refuses_what_the_reference_refuses(spec, n):
    with pytest.raises(ValueError):
        JS.parse_mesh_spec(spec, n)
    with pytest.raises(ValueError):
        PS.parse_mesh_spec(spec, n)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_rules_refuse_group_splitting_specs():
    """The reference's hand-made cases (tests/test_spmd.py): a 4-way
    "model" cut of a K=16 grouped axis (m=8) is dropped by the rules and
    rejected by the assert; an expert stack keeps whole experts and
    whole groups, and an uneven expert split is rejected."""
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    mesh = Mesh(PS.parse_mesh_spec("data=2,model=4", 8))
    out = PR.nm_params_pspecs({"blk": {"w": ("mlp", "embed")}},
                              PR.TRAIN_RULES, {"blk": {"w": _meta(16, 16)}},
                              mesh, sp)
    assert out["blk"]["w"][0] is None
    with pytest.raises(AssertionError, match="group split"):
        PR.assert_nm_unsplit({"blk": {"w": ("model", None)}},
                             {"blk": {"w": _meta(16, 16)}}, mesh, sp)
    params = {"moe": {"w_gate": _meta(8, 16, 16)}}
    out = PR.nm_params_pspecs({"moe": {"w_gate": ("expert", "embed", "mlp")}},
                              PR.TRAIN_RULES, params, mesh, sp)
    assert out["moe"]["w_gate"][:2] == ("model", "data")
    with pytest.raises(AssertionError, match="group split"):
        PR.assert_nm_unsplit({"moe": {"w_gate": (None, "model", None)}},
                             params, mesh, sp)
    with pytest.raises(AssertionError, match="group split"):
        PR.assert_nm_unsplit({"moe": {"w_gate": ("model", None, None)}},
                             {"moe": {"w_gate": _meta(6, 16, 16)}}, mesh, sp)
    out = PR.nm_params_pspecs({"moe": {"w_gate": ("expert", "mlp", None)}},
                              PR.SERVE_BATCH_RULES, params, mesh, sp)
    assert out["moe"]["w_gate"][1] is None


@pytest.mark.parametrize("n,kc,data,refused", [
    (3, 12, 2, False),   # odd N: 6 u4 bytes, 3 a shard = one byte pair
    (3, 12, 3, True),    # odd N: 2 bytes a shard cut a group pair
    (2, 8, 4, False),    # even N: 4 bytes, 1 a shard = N/2
    (2, 8, 8, True)])    # even N: a shard of half a byte row set
def test_u4_index_plane_guard_equals_the_reference(n, kc, data, refused):
    """A packed serving operand on a u4 index plane: the per-shard
    multiple along the compact axis is N/2 bytes for even N and N bytes
    (two groups) for odd N; the port refuses exactly what the reference
    refuses."""
    rows = -(-kc // 2)
    jsp, psp = JSparsity(n, 8, "bdwp"), SparsityConfig(n, 8, "bdwp")
    jmesh = AbstractMesh((data,), ("data",))
    pmesh = Mesh({"data": data})
    jspec = {"w": JO.PackedOp(P(None, None), P("data", None), jsp, 4)}
    jp = {"w": JO.PackedOp(_sds(kc, 16), jax.ShapeDtypeStruct(
        (rows, 16), jnp.uint8), jsp, 4)}
    pspec = {"w": PackedOp((None, None), ("data", None), psp, 4)}
    pp = {"w": PackedOp(_meta(kc, 16), _meta(rows, 16, dtype=torch.uint8),
                        psp, 4)}
    for fn, args in ((JR.assert_nm_unsplit, (jspec, jp, jmesh, jsp)),
                     (PR.assert_nm_unsplit, (pspec, pp, pmesh, psp))):
        if refused:
            with pytest.raises(AssertionError, match="group split"):
                fn(*args)
        else:
            fn(*args)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "whisper-large-v3"])
def test_slab_layout_equals_the_reference(arch):
    """``slab_shards``, ``local_block_shape`` of every leaf and the mesh
    form of ``err_state_elems`` (T_loc_pad x S) equal the reference's on
    the TRAIN rules' specs, for meshes whose "model" axis is 1 (where the
    port runs them)."""
    from repro.optim import compress as JC
    from repro_torch.optim import compress as PC

    ap, specs, pp, pspecs = _models(arch, "smoke")
    jsp, psp = JSparsity(2, 8, "bdwp"), SparsityConfig(2, 8, "bdwp")
    for shape in [(2, 2, 1), (1, 2, 1), (2, 4, 1), (1, 8, 1)]:
        jmesh, pmesh = _meshes(shape)
        jp = JR.nm_params_pspecs(specs, JR.TRAIN_RULES, ap, jmesh, jsp)
        mine = PR.nm_params_pspecs(pspecs, PR.TRAIN_RULES, pp, pmesh, psp)
        assert PC.slab_shards(pmesh) == JC.slab_shards(jmesh)
        for path, stacked, spec in _leaves(mine):
            ref_spec = _at(jp, path)
            leaf = _at(ap, path)
            port_leaf = next(x for p_, _, x in _leaves(pp) if p_ == path)
            ref_shape = JC.local_block_shape(leaf.shape, ref_spec, jmesh)
            got = PC.local_block_shape(tuple(port_leaf.shape), spec, pmesh)
            assert got == (ref_shape[1:] if stacked else ref_shape), path
        assert PC.err_state_elems(pp, 8, pmesh, mine) == \
            JC.err_state_elems(ap, 8, jmesh, jp), (arch, shape)
