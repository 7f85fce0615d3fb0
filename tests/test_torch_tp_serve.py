"""Tensor-parallel serving (``sharding.tp``, ``ServeEngine(mesh=)``) against
the reference's ``ServeEngine(mesh=)``.

(a) Planning: ``launch.spmd.serve_shardings`` equals the reference's on
    a ``jax.sharding.AbstractMesh``, leaf for leaf (its
    ``PartitionSpec``s as tuples; a per-layer leaf's spec without the
    reference's "layer" entry): the params, cache, token and pos specs
    of the nine LM archs' SMOKE configs and qwen3-8b FULL, on meshes
    (pod, data, model) = (1, 1, 2), (1, 1, 4), (1, 2, 2), packed u4,
    packed u8 and unpacked.
(b) Blocks: the rank's element pack of its blocks of qwen3-8b SMOKE is
    bitwise its block of the one-process pack, at M = 2 and 4.
(c) The engine: one reference subprocess pair
    (``tests/jax_tp_serve_reference.py``, a forced 4-device mesh) serves
    the reference's own sharded-vs-solo workload (``tests/test_spmd.py``
    ``TestServeParity``) at model = 2 (qwen3-8b packed u4 and masked,
    gemma3-12b u4) and model = 4 (qwen3-8b u4, whose KV projections cut
    into half heads and whose cache is whole on every rank); four gloo
    ranks (one ``mp.spawn``, file-store init) run the port's engine on
    the same weights, two pairs at model = 2 and then all four at
    model = 4.  Every rank's streams equal the reference's sharded and
    solo streams and the port's one-process streams exactly; every
    rank's store is bitwise its blocks of the one-process store; the
    collectives a step are counted.  In the same workers the
    teacher-forced prefill and decode logits of qwen2.5-32b (QKV bias),
    glm4-9b (one KV head: half-head k/v blocks gathered and the cache
    whole on every rank at M = 2 and 4) and internvl2-26b (a stub
    prefix) lie within LOGIT_ATOL of the port's one-process logits, and
    the vocab-parallel embedding lookup is bitwise the one-process
    lookup.
(d) Refusals: a mesh with "data" > 1, the MoE, MLA, SSM and hybrid
    archs and the encoder-decoder at model = 2 raise NotImplementedError
    naming ROADMAP item 7; a ready store that is not the rank's raises;
    a "model" axis without a process group raises.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.operand import PackedOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh, mesh_over_group
from repro_torch.models import layers as L
from repro_torch.models import transformer_lm as T
from repro_torch.serve.batcher import seat_cache
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.packed_params import PackedParamStore
from repro_torch.sharding import tp
from repro_torch.train import step as ST

ROOT = Path(__file__).resolve().parents[1]
SP = SparsityConfig(n=2, m=8, method="bdwp")
AXES = ("pod", "data", "model")
PLAN_MESHES = [(1, 1, 2), (1, 1, 4), (1, 2, 2)]
PACKINGS = {"u4": (True, 4), "u8": (True, 8), "unpacked": (False, None)}
LM_ARCHS = [a for a in ARCHS if get_arch(a).family == "lm"]
PLAN_CASES = [(a, "smoke") for a in LM_ARCHS] + [("qwen3-8b", "full")]
SERVE = dict(n_slots=4, max_len=32, prompt_bucket=12)
LENGTHS, NEW = (4, 7, 11, 5, 9), 8
# (arch, "model" ranks, packed) of the engine runs; the reference's two
# subprocesses take about the same time each
REF_JOBS = [["qwen3-8b:2:packed", "qwen3-8b:4:packed"],
            ["gemma3-12b:2:packed", "qwen3-8b:2:masked"]]
LOGIT_ARCHS = ("qwen2.5-32b", "glm4-9b", "internvl2-26b")
PREFIX = 6                 # internvl2's stub prefix, positions
LOGIT_STEPS = 6            # teacher-forced decode steps
# TP logits vs one process, packed u4 at SMOKE, on the CPU: the
# row-parallel sums may add two or four fp32 partial products in another
# order than one product does, and the bf16 roundings after them then
# move (logits of magnitude ~1); with one thread a rank the three archs
# at M = 2 and 4 measured a gap of 0
LOGIT_ATOL = 1e-4


def _world(rank, world, store):
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    # a rank that stops raises in the others' collectives instead of
    # leaving them waiting for gloo's default half hour
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))


# ---------------------------------------------------------------------------
# (a) planning parity
# ---------------------------------------------------------------------------


def _port_leaves(tree, path=(), stacked=False):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,), stacked)
    elif isinstance(tree, list):
        for v in tree:
            yield from _port_leaves(v, path, True)
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


def _check_specs(port_tree, ref_tree, stacked_key):
    from repro.core import operand as JO

    n = 0
    for path, stacked, node in _port_leaves(port_tree):
        ref = _at(ref_tree, path)
        stacked = stacked and path[0] == stacked_key
        if isinstance(node, PackedOp):
            assert isinstance(ref, JO.PackedOp), path
            assert node.idx_bits == ref.idx_bits, path
            _same(node.vals, ref.vals, stacked, path + ("vals",))
            _same(node.idx, ref.idx, stacked, path + ("idx",))
        else:
            _same(node, ref, stacked, path)
        n += 1
    return n


@pytest.mark.parametrize("packing", list(PACKINGS))
@pytest.mark.parametrize("arch,size", PLAN_CASES)
def test_serve_shardings_equal_the_reference(arch, size, packing):
    from jax.sharding import AbstractMesh

    from repro.configs import get_arch as ref_arch
    from repro.core.sparsity import SparsityConfig as JSparsity
    from repro.launch import spmd as JS

    packed, bits = PACKINGS[packing]
    jcfg, pcfg = getattr(ref_arch(arch), size), getattr(get_arch(arch), size)
    for shape in PLAN_MESHES:
        kw = dict(n_slots=4, max_len=32, packed=packed, idx_bits=bits)
        ref = JS.serve_shardings(jcfg, AbstractMesh(shape, AXES),
                                 JSparsity(2, 8, "bdwp"), **kw)["pspecs"]
        mine = spmd.serve_shardings(pcfg, Mesh(dict(zip(AXES, shape))), SP,
                                    **kw)
        assert set(mine) == {"params", "cache", "token", "pos"}
        n = _check_specs(mine["params"], ref["params"], "blocks")
        assert n == len(tp.leaf_shapes(T.abstract_params(pcfg)))
        _check_specs(mine["cache"], ref["cache"], "layers")
        assert mine["token"] == tuple(ref["token"])
        assert mine["pos"] == tuple(ref["pos"])


def test_sanitize_pspec_equals_the_reference():
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.launch import spmd as JS

    jmesh = AbstractMesh((1, 2, 4), AXES)
    pmesh = Mesh(dict(zip(AXES, (1, 2, 4))))
    for ps, shape in [((("pod", "data"), None), (3, 1)),
                      ((("pod", "data"), None), (4, 1)),
                      (("model", None, "data"), (8, 5, 6)),
                      (("model", None, "data"), (6, 5, 3)), ((None,), (7,))]:
        assert spmd._sanitize_pspec(ps, shape, pmesh) == tuple(
            JS._sanitize_pspec(P(*ps), shape, jmesh))


# ---------------------------------------------------------------------------
# (b) the rank's blocks of the pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("idx_bits", [4, 8])
def test_rank_pack_is_its_block_of_the_whole_pack(model, idx_bits):
    cfg = get_arch("qwen3-8b").smoke
    params = T.init(cfg, seed=1, device="cpu", dtype=torch.bfloat16)
    whole = PackedParamStore.pack(params, SP, idx_bits, device="cpu")
    like = T.abstract_params(cfg)
    n_packed = 0
    for rank in range(model):
        mesh = Mesh({"data": 1, "model": model}, rank)
        specs = spmd.serve_shardings(cfg, mesh, SP, n_slots=4, max_len=32,
                                     packed=True, idx_bits=idx_bits)
        mine = PackedParamStore.pack(tp.serve_blocks(
            params, specs["params"], mesh), SP, idx_bits, device="cpu",
            like=like)
        want = tp.serve_blocks(whole.params, specs["params"], mesh)
        assert (mine.n_packed, mine.n_dense) == (whole.n_packed,
                                                 whole.n_dense)
        got_leaves = list(_port_leaves(mine.params))
        for (path, _, a), (_, _, b) in zip(got_leaves, _port_leaves(want)):
            if isinstance(a, PackedOp):
                assert isinstance(b, PackedOp), path
                assert torch.equal(a.vals, b.vals), path
                assert torch.equal(a.idx, b.idx), path
                n_packed += 1
            else:
                assert torch.equal(a, b), path
        assert tp.leaf_shapes(mine.params) == tp.leaf_shapes(want)
        # the KV projections at M = 4 are half a head wide: still packed
        k = mine.params["blocks"][0]["attn"]["k_proj"]["w"]
        assert isinstance(k, PackedOp)
        assert k.vals.shape[-1] == cfg.n_kv * cfg.head_dim // model
    assert n_packed == 7 * cfg.n_layers * model


# ---------------------------------------------------------------------------
# (c) the engine over gloo ranks against the reference's
# ---------------------------------------------------------------------------


def _requests(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in LENGTHS]


def _serve(params, cfg, packed, mesh):
    eng = ServeEngine(params, cfg, SP, ServeConfig(packed=packed, **SERVE),
                      device="cpu", mesh=mesh)
    tp.reset_stats()
    for p in _requests(cfg):
        eng.submit(p, max_new_tokens=NEW)
    streams = eng.run()
    return eng, streams, dict(tp.stats), eng.stats()


def _engine_case(params, cfg, packed, mesh):
    """The TP engine's streams, stats and its store against the
    one-process store, and the one-process engine's streams."""
    eng, streams, counts, st = _serve(params, cfg, packed, mesh)
    solo, solo_streams, _, _ = _serve(params, cfg, packed, None)
    out = {"streams": streams, "solo": solo_streams, "counts": counts,
           "stats": st}
    if packed:
        specs = spmd.serve_shardings(cfg, mesh, SP, n_slots=4, max_len=32,
                                     packed=True)["params"]
        want = tp.serve_blocks(solo.store.params, specs, mesh)
        out["store_bitwise"] = all(
            torch.equal(a.vals, b.vals) and torch.equal(a.idx, b.idx)
            if isinstance(a, PackedOp) else torch.equal(a, b)
            for (_, _, a), (_, _, b) in zip(_port_leaves(eng.store.params),
                                            _port_leaves(want)))
        out["store_bytes"] = (eng.store.total_bytes, solo.store.total_bytes)
    return out


def _logit_case(params, cfg, mesh):
    """Teacher-forced prefill + LOGIT_STEPS decode steps, TP against one
    process (packed u4): the largest logit gap, and whether the
    vocab-parallel embedding lookup was bitwise."""
    whole = PackedParamStore.pack(params, SP, 4, device="cpu")
    specs = spmd.serve_shardings(cfg, mesh, SP, n_slots=1, max_len=32,
                                 packed=True, idx_bits=4)["params"]
    blocks = PackedParamStore.pack(tp.serve_blocks(params, specs, mesh), SP,
                                   4, device="cpu",
                                   like=T.abstract_params(cfg)).params
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 9)))
    forced = rng.integers(0, cfg.vocab, LOGIT_STEPS)
    batch = {"tokens": toks}
    if cfg.name.startswith("internvl2"):
        batch["prefix_embeds"] = torch.from_numpy(
            rng.standard_normal((1, PREFIX, cfg.d_model)).astype(
                np.float32)).to(torch.bfloat16)
    s_tot = toks.shape[1] + (PREFIX if "prefix_embeds" in batch else 0)
    gaps = []
    runs = {}
    for name, tree, m in (("solo", whole.params, None), ("tp", blocks, mesh)):
        logits, pre = ST.lm_prefill_step(tree, batch, cfg=cfg, sp_cfg=SP,
                                         mesh=m)
        cache = (T.init_lm_cache(cfg, 1, 32, device="cpu") if m is None
                 else tp.init_cache(cfg, 1, 32, m, device="cpu"))
        seat_cache(cache, pre, 0)
        out = [logits]
        for i, t in enumerate(forced):
            lg, cache = ST.lm_decode_step(
                tree, cache, torch.tensor([[int(t)]]),
                torch.tensor([s_tot + i]), cfg=cfg, sp_cfg=SP, mesh=m)
            out.append(lg)
        runs[name] = out
    for a, b in zip(runs["solo"], runs["tp"]):
        assert a.shape == b.shape == (1, 1, cfg.padded_vocab)
        gaps.append(float((a - b).abs().max()))
    with tp.model_split(tp.split_of(mesh)):
        lookup = L.embed_apply(blocks["embed"], toks, rows=cfg.padded_vocab)
    return {"gaps": gaps, "embed_bitwise": torch.equal(
        lookup, L.embed_apply(whole.params["embed"], toks))}


def _worker(rank, store, out_dir, params):
    import torch.distributed as dist

    _world(rank, 4, store)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = Mesh({"data": 1, "model": 2}, rank % 2,
                {"model": pairs[rank // 2]})
    qwen, gemma = get_arch("qwen3-8b").smoke, get_arch("gemma3-12b").smoke
    out = {}
    if rank < 2:
        out["qwen3-8b", 2, True] = _engine_case(params["qwen3-8b"], qwen,
                                                True, pair)
        out["qwen3-8b", 2, False] = _engine_case(params["qwen3-8b"], qwen,
                                                 False, pair)
    else:
        out["gemma3-12b", 2, True] = _engine_case(params["gemma3-12b"],
                                                  gemma, True, pair)
        for arch in LOGIT_ARCHS:
            out["logits", arch, 2] = _logit_case(
                params[arch], get_arch(arch).smoke, pair)
    four = mesh_over_group({"data": 1, "model": 4})
    out["qwen3-8b", 4, True] = _engine_case(params["qwen3-8b"], qwen, True,
                                            four)
    for arch in LOGIT_ARCHS:
        out["logits", arch, 4] = _logit_case(params[arch],
                                             get_arch(arch).smoke, four)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _params(d, procs):
    """qwen3-8b's and gemma3-12b's weights as the reference subprocesses
    drew them (``PRNGKey(0)``, bf16), and the logit archs' from a seed."""
    out = {}
    for i, proc in enumerate(procs):
        path = d / f"ref{i}.pkl.params"
        start = time.monotonic()
        while not path.exists():   # written whole, then renamed into place
            assert proc.poll() is None, (
                d / f"ref{i}.err").read_text()[-4000:]
            assert time.monotonic() - start < 300
            time.sleep(0.2)
        with open(path, "rb") as f:
            out.update({a: convert.params_from_jax(p, device="cpu")
                        for a, p in pickle.load(f).items()})
    for arch in LOGIT_ARCHS:
        out[arch] = T.init(get_arch(arch).smoke, seed=0, device="cpu",
                           dtype=torch.bfloat16)
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_jobs(tmp_path_factory):
    """The reference's subprocesses, started before the module's first
    test so that they run beside the planning tests; stopped at its
    end if they still run."""
    d = tmp_path_factory.mktemp("tp_serve")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for i, job in enumerate(REF_JOBS):
        with open(d / f"ref{i}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable,
                 str(ROOT / "tests" / "jax_tp_serve_reference.py"),
                 str(d / f"ref{i}.pkl"), *job], env=env,
                stdout=subprocess.DEVNULL, stderr=err))
    yield d, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(reference_jobs):
    d, procs = reference_jobs
    params = _params(d, procs)
    mp.spawn(_worker, args=(str(d / "store"), str(d), params), nprocs=4)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    ref = {}
    for i, proc in enumerate(procs):
        assert proc.wait(timeout=600) == 0, (
            d / f"ref{i}.err").read_text()[-4000:]
        with open(d / f"ref{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    return ref, ranks, params


def _ranks_of(case, ranks):
    return [r[case] for r in ranks if case in r]


@pytest.mark.parametrize("case", [("qwen3-8b", 2, True),
                                  ("qwen3-8b", 2, False),
                                  ("qwen3-8b", 4, True),
                                  ("gemma3-12b", 2, True)],
                         ids=["qwen3-m2-u4", "qwen3-m2-masked",
                              "qwen3-m4-u4", "gemma3-m2-u4"])
def test_streams_equal_the_reference_sharded_and_solo(runs, case):
    ref, ranks, _ = runs
    got = _ranks_of(case, ranks)
    assert len(got) == case[1]
    want = ref[case]["sharded"]
    assert want == ref[case]["solo"]
    assert [len(s) for s in want.values()] == [NEW] * len(LENGTHS)
    for r in got:
        assert r["streams"] == want
        assert r["solo"] == want


@pytest.mark.parametrize("case", [("qwen3-8b", 2, True),
                                  ("qwen3-8b", 4, True),
                                  ("gemma3-12b", 2, True)],
                         ids=["qwen3-m2", "qwen3-m4", "gemma3-m2"])
def test_rank_store_is_its_block_of_the_one_process_store(runs, case):
    got = _ranks_of(case, runs[1])
    assert got and all(r["store_bitwise"] for r in got)
    mine, whole = got[0]["store_bytes"]
    assert mine < whole


@pytest.mark.parametrize("case", [("qwen3-8b", 2, True),
                                  ("qwen3-8b", 4, True),
                                  ("gemma3-12b", 2, True)],
                         ids=["qwen3-m2", "qwen3-m4", "gemma3-m2"])
def test_collectives_per_step(runs, case):
    """Per forward (a prefill or a decode step): two all-reduces a layer
    (o_proj, w_down), one embedding lookup, one logits gather, and two
    KV gathers a layer where the KV projections' blocks are half heads
    (qwen3-8b and gemma3-12b SMOKE at M = 4: n_kv = 2)."""
    arch, model, _ = case
    cfg = get_arch(arch).smoke
    kv_gathers = 2 if cfg.n_kv % model else 0
    for r in _ranks_of(case, runs[1]):
        c, st = r["counts"], r["stats"]
        fwd = st["prefill_steps"] + st["decode_steps"]
        assert fwd > 0
        assert c["all_reduces"] == 2 * cfg.n_layers * fwd
        assert c["embed_lookups"] == fwd
        assert c["gathers"] == fwd * (1 + kv_gathers * cfg.n_layers)


@pytest.mark.parametrize("arch", LOGIT_ARCHS)
@pytest.mark.parametrize("model", [2, 4])
def test_tp_logits_track_one_process(runs, arch, model):
    got = _ranks_of(("logits", arch, model), runs[1])
    assert len(got) == model
    for r in got:
        assert len(r["gaps"]) == LOGIT_STEPS + 1
        assert max(r["gaps"]) <= LOGIT_ATOL, r["gaps"]
        assert r["embed_bitwise"]
    assert all(r["gaps"] == got[0]["gaps"] for r in got)


# ---------------------------------------------------------------------------
# (d) refusals
# ---------------------------------------------------------------------------


def test_a_mesh_with_data_ranks_is_refused():
    cfg = get_arch("qwen3-8b").smoke
    params = T.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for shape in ({"data": 2, "model": 1}, {"data": 2, "model": 2},
                  {"pod": 2, "data": 1, "model": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
            ServeEngine(params, cfg, SP, ServeConfig(packed=True, **SERVE),
                        device="cpu", mesh=Mesh(shape))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "mamba2-370m",
                                  "hymba-1.5b", "whisper-large-v3"])
def test_other_archs_over_model_are_refused(arch):
    cfg = get_arch(arch).smoke
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        ServeEngine({}, cfg, SP, ServeConfig(packed=True, **SERVE),
                    device="cpu", mesh=Mesh({"data": 1, "model": 2}))


def test_a_store_that_is_not_the_ranks_is_refused():
    cfg = get_arch("qwen3-8b").smoke
    params = T.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    whole = PackedParamStore.pack(params, SP, device="cpu")
    # the check comes before any collective: a stand-in group will do
    mesh = Mesh({"data": 1, "model": 2}, 1, {"model": object()})
    with pytest.raises(ValueError, match="not this rank's"):
        ServeEngine(whole, cfg, SP, ServeConfig(packed=True, **SERVE),
                    device="cpu", mesh=mesh)
    specs = spmd.serve_shardings(cfg, mesh, SP, n_slots=4, max_len=32,
                                 packed=True)["params"]
    other = Mesh({"data": 1, "model": 2}, 0, {"model": object()})
    with pytest.raises(ValueError, match="not this rank's"):
        ServeEngine(dataclasses.replace(
            whole, params=tp.serve_blocks(whole.params, specs, other)),
            cfg, SP, ServeConfig(packed=True, **SERVE), device="cpu",
            mesh=Mesh({"data": 1, "model": 4}, 1, {"model": object()}))


def test_a_model_axis_without_a_group_raises():
    cfg = get_arch("qwen3-8b").smoke
    mesh = Mesh({"data": 1, "model": 2})
    with pytest.raises(RuntimeError, match="no process group"):
        ST.lm_prefill_step({}, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                           cfg=cfg, sp_cfg=SP, mesh=mesh)
    assert tp.split_of(Mesh({"data": 2, "model": 1})) is None
    assert tp.current() is None
