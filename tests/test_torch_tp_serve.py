"""Sharded serving (``sharding.tp``, ``ServeEngine(mesh=)``,
``train.step.build_lm_serve``) against the reference's.

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
(d) Refusals: the MoE, MLA, SSM and hybrid archs and the
    encoder-decoder at model = 2 raise NotImplementedError naming
    ROADMAP item 7, in the engine and in ``build_lm_serve``, and
    ``build_lm_serve(long_context=True)`` names item 7.2b; a ready
    store that is not the rank's raises; a "model" or DP axis without a
    process group raises.
(e) Slot lanes over the DP axes: the slot-block arithmetic (and the
    replicated slots where D does not divide them) and the DP group's
    ranks, with no ranks; in the same reference subprocesses and
    spawn, the engine at (pod, data, model) = (1, 2, 2) and (2, 2, 1)
    (qwen3-8b u4), (1, 4, 1) (masked), (1, 2, 1) with 3 slots
    (replicated), granite-moe and deepseek at (2, 2, 1) (the routing
    groups span ranks) and mamba2 and hymba at (1, 2, 1): every rank's
    streams equal the reference's sharded and solo streams; one token
    gather a decode step; a lane exported from another rank's slot
    equals the one-process export.
(f) ``build_lm_serve`` at (1, 2, 2), masked and shared-packed: the
    shared pack's specs equal the reference's, a rank's column blocks
    are bitwise the whole pack's and its row blocks' rebased rows plus
    r K / M too, the row-parallel fp32 partial products sum to the
    whole product; a prefill and SERVE_STEPS forced decode steps on
    every rank within LM_SERVE_ATOL of the reference's sharded bundle,
    with the collectives a step counted.
"""

import dataclasses
import math
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
from repro_torch.core import bdwp as TB
from repro_torch.core import operand as O
from repro_torch.core.operand import PackedOp, SharedOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import spmd
from repro_torch.launch.mesh import DP_AXES, Mesh, axis_ranks, mesh_over_group
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
# the reference's cases (``tests/jax_tp_serve_reference.py``): engine
# runs ARCH:P,D,M:packed|masked[:slots] and build_lm_serve runs
# serve:ARCH:P,D,M:...; the three subprocesses take about the same time
REF_JOBS = [["qwen3-8b:1,1,2:packed", "qwen3-8b:1,1,4:packed",
             "qwen3-8b:1,2,2:packed", "qwen3-8b:2,2,1:packed",
             "qwen3-8b:1,2,1:packed:3"],
            ["gemma3-12b:1,1,2:packed", "qwen3-8b:1,1,2:masked",
             "qwen3-8b:1,4,1:masked", "serve:qwen3-8b:1,2,2:packed",
             "serve:qwen3-8b:1,2,2:masked"],
            ["granite-moe-1b-a400m:2,2,1:packed",
             "deepseek-v2-lite-16b:2,2,1:packed", "mamba2-370m:1,2,1:packed",
             "hymba-1.5b:1,2,1:packed"]]
LOGIT_ARCHS = ("qwen2.5-32b", "glm4-9b", "internvl2-26b")
PREFIX = 6                 # internvl2's stub prefix, positions
LOGIT_STEPS = 6            # teacher-forced decode steps
# TP logits vs one process, packed u4 at SMOKE, on the CPU: the
# row-parallel sums may add two or four fp32 partial products in another
# order than one product does, and the bf16 roundings after them then
# move (logits of magnitude ~1); with one thread a rank the three archs
# at M = 2 and 4 measured a gap of 0
LOGIT_ATOL = 1e-4
# build_lm_serve's logits against the reference's sharded bundle: on the
# CPU that bundle lands up to 0.047 from the reference's own one-device
# bundle (packed 0.032, masked 0.047 at these rows: GSPMD's sharded
# program rounds otherwise), so it holds at twice that; the port's
# sharded logits are held to the one-device bundle at LOGIT_ATOL
LM_SERVE_ATOL = 0.1
SERVE_STEPS = 4            # the reference script's forced decode steps


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
        if isinstance(node, (PackedOp, SharedOp)):
            assert isinstance(ref, JO.PackedOp if isinstance(
                node, PackedOp) else JO.SharedOp), path
            if isinstance(node, PackedOp):
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


def _serve(params, cfg, packed, mesh, slots=4):
    eng = ServeEngine(params, cfg, SP, ServeConfig(
        packed=packed, **dict(SERVE, n_slots=slots)), device="cpu",
        mesh=mesh)
    tp.reset_stats()
    for p in _requests(cfg):
        eng.submit(p, max_new_tokens=NEW)
    streams = eng.run()
    return eng, streams, dict(tp.stats), eng.stats()


def _engine_case(params, cfg, packed, mesh, slots=4):
    """The sharded engine's streams, stats and its store against the
    one-process store, and the one-process engine's streams."""
    eng, streams, counts, st = _serve(params, cfg, packed, mesh, slots)
    solo, solo_streams, _, _ = _serve(params, cfg, packed, None, slots)
    out = {"streams": streams, "solo": solo_streams, "counts": counts,
           "stats": st}
    if packed:
        specs = spmd.serve_shardings(cfg, mesh, SP, n_slots=slots,
                                     max_len=32, packed=True)["params"]
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


def _lane_case(params, cfg, mesh):
    """Run the workload three steps on a DP engine at "model" = 1 and on
    one process, then export the lane of every running request on both:
    the DP engine's (its owner's, shared over the DP group) equal to the
    one-process one, bitwise."""
    lanes, shares = [], []
    for m in (mesh, None):
        eng = ServeEngine(params, cfg, SP, ServeConfig(packed=True, **SERVE),
                          device="cpu", mesh=m)
        for p in _requests(cfg):
            eng.submit(p, max_new_tokens=NEW)
        for _ in range(3):
            eng.step()
        tp.reset_stats()
        lanes.append([eng.export_lane(r.rid) for r in sorted(
            eng._running.values(), key=lambda r: r.slot)])
        shares.append(tp.stats["lane_shares"])
    ok = len(lanes[0]) == len(lanes[1]) > 1
    for a, b in zip(*lanes):
        ok &= (a.next_token, a.pos) == (b.next_token, b.pos)
        ta, tb = ([t for lc in x.cache["layers"] for t in lc.values()
                   if isinstance(t, torch.Tensor)] for x in (a, b))
        ok &= len(ta) == len(tb) and all(torch.equal(x, y)
                                         for x, y in zip(ta, tb))
    return {"equal": ok, "lanes": len(lanes[0]), "shares": shares[0]}


def _seat_rows(cache, pre, s):
    """A prefill cache of S positions into the first S of a deeper one
    (every row), its cursors at S."""
    for dst, src in zip(cache["layers"], pre["layers"]):
        for key, t in src.items():
            if isinstance(t, torch.Tensor):
                dst[key][:, :t.shape[1]] = t
            else:
                dst[key] = s
    return cache


def _lm_serve_case(params, cfg, packed, mesh, tokens, forced):
    """``build_lm_serve``'s prefill and SERVE_STEPS forced decode steps
    on the rank's blocks and rows: the whole batch's logits of each
    step (fp32) and the collectives."""
    b, s = tokens.shape
    meta = T.init_lm_cache(cfg, b, s + SERVE_STEPS, device="meta")
    pre = ST.build_lm_serve(cfg, mesh, SP, {"tokens": tokens.to("meta")},
                            prefill=True, packed=packed)
    dec = ST.build_lm_serve(cfg, mesh, SP, {
        "cache": meta, "token": tokens[:, :1].to("meta"),
        "pos": torch.empty((), device="meta")}, packed=packed)
    tree = TB.pack_tree_shared(params, SP, device="cpu") if packed else params
    blocks = tp.serve_blocks(tree, pre.state_shardings, mesh)
    lo, hi = tp.slot_block(b, mesh)
    tp.reset_stats()
    logits, cache1 = pre.step_fn(blocks, {"tokens": tokens[lo:hi]})
    cache = _seat_rows(tp.init_cache(cfg, hi - lo, s + SERVE_STEPS, mesh,
                                     device="cpu"), cache1, s)
    out = [logits]
    for i in range(SERVE_STEPS):
        logits, cache = dec.step_fn(blocks, cache, forced[i, lo:hi, None],
                                    s + i)
        out.append(logits)
    return {"logits": torch.stack(out).float(), "counts": dict(tp.stats),
            "rows": (lo, hi)}


def _pair_dp(rank, pairs):
    """A pair's mesh over "data", its DP group the pair's, as
    ``build_groups`` keys it."""
    g = pairs[rank // 2]
    return Mesh({"data": 2, "model": 1}, rank % 2, {"data": g, DP_AXES: g})


def _worker(rank, store, out_dir, params, serve_inputs):
    import torch.distributed as dist

    _world(rank, 4, store)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = Mesh({"data": 1, "model": 2}, rank % 2,
                {"model": pairs[rank // 2]})
    qwen, gemma = get_arch("qwen3-8b").smoke, get_arch("gemma3-12b").smoke
    out = {}
    if rank < 2:
        out["qwen3-8b", (1, 1, 2), True, 4] = _engine_case(
            params["qwen3-8b"], qwen, True, pair)
        out["qwen3-8b", (1, 1, 2), False, 4] = _engine_case(
            params["qwen3-8b"], qwen, False, pair)
        dp = _pair_dp(rank, pairs)
        out["qwen3-8b", (1, 2, 1), True, 3] = _engine_case(
            params["qwen3-8b"], qwen, True, dp, slots=3)
        out["mamba2-370m", (1, 2, 1), True, 4] = _engine_case(
            params["mamba2-370m"], get_arch("mamba2-370m").smoke, True, dp)
    else:
        out["gemma3-12b", (1, 1, 2), True, 4] = _engine_case(
            params["gemma3-12b"], gemma, True, pair)
        for arch in LOGIT_ARCHS:
            out["logits", arch, 2] = _logit_case(
                params[arch], get_arch(arch).smoke, pair)
        out["hymba-1.5b", (1, 2, 1), True, 4] = _engine_case(
            params["hymba-1.5b"], get_arch("hymba-1.5b").smoke, True,
            _pair_dp(rank, pairs))
    four = mesh_over_group({"data": 1, "model": 4})
    out["qwen3-8b", (1, 1, 4), True, 4] = _engine_case(
        params["qwen3-8b"], qwen, True, four)
    for arch in LOGIT_ARCHS:
        out["logits", arch, 4] = _logit_case(params[arch],
                                             get_arch(arch).smoke, four)
    meshes = {shape: mesh_over_group(dict(zip(AXES, shape)))
              for shape in ((1, 2, 2), (2, 2, 1), (1, 4, 1))}
    for arch, shape, packed in DP_ENGINE_CASES:
        out[arch, shape, packed, 4] = _engine_case(
            params[arch], get_arch(arch).smoke, packed, meshes[shape])
    out["lanes", (2, 2, 1)] = _lane_case(params["qwen3-8b"], qwen,
                                         meshes[2, 2, 1])
    for packed in (True, False):
        tokens, forced = serve_inputs[packed]
        out["serve", packed] = _lm_serve_case(
            params["qwen3-8b"], qwen, packed, meshes[1, 2, 2], tokens, forced)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# the four-rank engine cases of (e), after the pairs' (1, 2, 1) cases
DP_ENGINE_CASES = [("qwen3-8b", (1, 2, 2), True), ("qwen3-8b", (2, 2, 1), True),
                   ("qwen3-8b", (1, 4, 1), False),
                   ("granite-moe-1b-a400m", (2, 2, 1), True),
                   ("deepseek-v2-lite-16b", (2, 2, 1), True)]


def _params(d, procs):
    """The archs' weights as the reference subprocesses drew them
    (``PRNGKey(0)``, bf16), and the logit archs' from a seed."""
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


def _serve_inputs():
    """The reference script's build_lm_serve rows and forced tokens."""
    cfg = get_arch("qwen3-8b").smoke
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 12)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_STEPS, 4)))
    return {True: (tokens, forced), False: (tokens, forced)}


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
    mp.spawn(_worker, args=(str(d / "store"), str(d), params,
                            _serve_inputs()), nprocs=4)
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


TP_IDS = {("qwen3-8b", (1, 1, 2), True, 4): "qwen3-m2-u4",
          ("qwen3-8b", (1, 1, 2), False, 4): "qwen3-m2-masked",
          ("qwen3-8b", (1, 1, 4), True, 4): "qwen3-m4-u4",
          ("gemma3-12b", (1, 1, 2), True, 4): "gemma3-m2-u4"}
DP_IDS = {("qwen3-8b", (1, 2, 2), True, 4): "qwen3-122-u4",
          ("qwen3-8b", (2, 2, 1), True, 4): "qwen3-221-u4",
          ("qwen3-8b", (1, 4, 1), False, 4): "qwen3-141-masked",
          ("qwen3-8b", (1, 2, 1), True, 3): "qwen3-121-u4-3slots",
          ("granite-moe-1b-a400m", (2, 2, 1), True, 4): "granite-221-u4",
          ("deepseek-v2-lite-16b", (2, 2, 1), True, 4): "deepseek-221-u4",
          ("mamba2-370m", (1, 2, 1), True, 4): "mamba2-121-u4",
          ("hymba-1.5b", (1, 2, 1), True, 4): "hymba-121-u4"}


@pytest.mark.parametrize("case", list(TP_IDS) + list(DP_IDS),
                         ids=list(TP_IDS.values()) + list(DP_IDS.values()))
def test_streams_equal_the_reference_sharded_and_solo(runs, case):
    ref, ranks, _ = runs
    got = _ranks_of(case, ranks)
    assert len(got) == math.prod(case[1])
    want = ref[case]["sharded"]
    assert want == ref[case]["solo"]
    assert [len(s) for s in want.values()] == [NEW] * len(LENGTHS)
    for r in got:
        assert r["streams"] == want
        assert r["solo"] == want


# the packed qwen3-8b and gemma3-12b runs: stores and collectives
PACKED_IDS = {("qwen3-8b", (1, 1, 2), True, 4): "qwen3-m2",
              ("qwen3-8b", (1, 1, 4), True, 4): "qwen3-m4",
              ("gemma3-12b", (1, 1, 2), True, 4): "gemma3-m2",
              ("qwen3-8b", (1, 2, 2), True, 4): "qwen3-122",
              ("qwen3-8b", (2, 2, 1), True, 4): "qwen3-221",
              ("qwen3-8b", (1, 2, 1), True, 3): "qwen3-121-3slots"}


@pytest.mark.parametrize("case", list(PACKED_IDS),
                         ids=list(PACKED_IDS.values()))
def test_rank_store_is_its_block_of_the_one_process_store(runs, case):
    """Its blocks over "model"; the whole store at "model" = 1 (no
    weight is cut over DP)."""
    got = _ranks_of(case, runs[1])
    assert got and all(r["store_bitwise"] for r in got)
    mine, whole = got[0]["store_bytes"]
    assert mine < whole if case[1][2] > 1 else mine == whole


def _want_tp(cfg, model, fwd):
    """Per forward at "model" = M > 1: two all-reduces a layer (o_proj,
    w_down), one embedding lookup, one logits gather, and two KV
    gathers a layer where the KV projections' blocks are half heads."""
    if model == 1:
        return {"all_reduces": 0, "embed_lookups": 0, "gathers": 0}
    kv_gathers = 2 if cfg.n_kv % model else 0
    return {"all_reduces": 2 * cfg.n_layers * fwd, "embed_lookups": fwd,
            "gathers": fwd * (1 + kv_gathers * cfg.n_layers)}


@pytest.mark.parametrize("case", list(PACKED_IDS),
                         ids=list(PACKED_IDS.values()))
def test_collectives_per_step(runs, case):
    """Per forward (a prefill or a decode step): the "model" axis'
    collectives (``_want_tp``); over the DP axes one token gather a
    decode step where the slots are cut (none where they are
    replicated) and none a prefill (every DP rank prefills)."""
    arch, shape, _, slots = case
    cfg = get_arch(arch).smoke
    split = slots % (shape[0] * shape[1]) == 0 and shape[0] * shape[1] > 1
    for r in _ranks_of(case, runs[1]):
        c, st = r["counts"], r["stats"]
        fwd = st["prefill_steps"] + st["decode_steps"]
        assert fwd > 0
        for k, v in _want_tp(cfg, shape[2], fwd).items():
            assert c[k] == v, (k, c)
        assert c["dp_gathers"] == (st["decode_steps"] if split else 0)
        assert c["lane_shares"] == 0


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


def test_lane_export_from_another_ranks_slot(runs):
    """At (2, 2, 1) each rank holds one of the 4 slots: every exported
    lane came from its owner and equals the one-process export."""
    got = _ranks_of(("lanes", (2, 2, 1)), runs[1])
    assert len(got) == 4
    for r in got:
        assert r["equal"] and r["lanes"] == 4 and r["shares"] == 4


@pytest.mark.parametrize("packed", [True, False], ids=["shared", "masked"])
def test_lm_serve_logits_track_the_reference(runs, packed):
    """build_lm_serve at (1, 2, 2): every rank's whole-batch logits the
    same bits, within LOGIT_ATOL of the reference's one-device bundle
    and LM_SERVE_ATOL of its sharded one (which lowers on the CPU); per
    forward the "model" axis' collectives and one DP logits gather."""
    ref, ranks, _ = runs
    want = ref["serve", "qwen3-8b", (1, 2, 2), packed]
    assert not isinstance(want["sharded"], str), want["sharded"]
    assert not isinstance(want["one"], str), want["one"]
    np.testing.assert_allclose(want["sharded"], want["one"],
                               atol=LM_SERVE_ATOL, rtol=0)
    got = _ranks_of(("serve", packed), ranks)
    assert len(got) == 4
    cfg = get_arch("qwen3-8b").smoke
    for rank, r in enumerate(got):
        assert torch.equal(r["logits"], got[0]["logits"])
        assert r["logits"].shape == (SERVE_STEPS + 1, 4, 1, cfg.padded_vocab)
        np.testing.assert_allclose(r["logits"].numpy(), want["one"],
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(r["logits"].numpy(), want["sharded"],
                                   atol=LM_SERVE_ATOL, rtol=0)
        for k, v in _want_tp(cfg, 2, SERVE_STEPS + 1).items():
            assert r["counts"][k] == v, (k, r["counts"])
        assert r["counts"]["dp_gathers"] == SERVE_STEPS + 1
        assert r["rows"] == tp.slot_block(4, Mesh(
            dict(zip(AXES, (1, 2, 2))), rank))


# ---------------------------------------------------------------------------
# (d) refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "mamba2-370m",
                                  "hymba-1.5b", "whisper-large-v3"])
def test_other_archs_over_model_are_refused(arch):
    """In the engine and in build_lm_serve; over the DP axes alone
    build_lm_serve plans every LM arch."""
    cfg = get_arch(arch).smoke
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        ServeEngine({}, cfg, SP, ServeConfig(packed=True, **SERVE),
                    device="cpu", mesh=Mesh({"data": 1, "model": 2}))
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        ST.build_lm_serve(cfg, Mesh(dict(zip(AXES, (1, 2, 2)))), SP, {},
                          packed=True)
    if arch != "whisper-large-v3":
        ST.build_lm_serve(cfg, Mesh(dict(zip(AXES, (2, 2, 1)))), SP, {},
                          packed=True)


def test_lm_serve_long_context_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP item 7.2b"):
        ST.build_lm_serve(get_arch("qwen3-8b").smoke,
                          Mesh(dict(zip(AXES, (1, 2, 2)))), SP, {},
                          long_context=True, prefill=True)


def test_lm_serve_batch_that_dp_does_not_divide_is_refused():
    """The reference's shardings put the batch over the DP axes, and
    jax.jit refuses a batch they do not divide; so does the port, at
    build time, and its step refuses rows that are not a rank's block."""
    cfg = get_arch("qwen3-8b").smoke
    meta = torch.empty((8, 8), dtype=torch.long, device="meta")
    for shape, b in (((1, 2, 1), 3), ((1, 2, 2), 1), ((2, 2, 1), 6)):
        mesh = Mesh(dict(zip(AXES, shape)))
        with pytest.raises(ValueError, match="does not divide"):
            ST.build_lm_serve(cfg, mesh, SP, {"tokens": meta[:b]},
                              prefill=True)
        with pytest.raises(ValueError, match="does not divide"):
            ST.build_lm_serve(cfg, mesh, SP, {"token": meta[:b, :1]})
    mesh = Mesh(dict(zip(AXES, (1, 2, 1))))
    pre = ST.build_lm_serve(cfg, mesh, SP, {"tokens": meta[:4]},
                            prefill=True)
    with pytest.raises(ValueError, match="not 4 rows"):
        pre.step_fn({}, {"tokens": torch.zeros((4, 8), dtype=torch.long)})
    bare = ST.build_lm_serve(cfg, mesh, SP, {}, prefill=True)
    with pytest.raises(ValueError, match="None rows"):
        bare.step_fn({}, {"tokens": torch.zeros((2, 8), dtype=torch.long)})


def test_a_dp_axis_without_a_group_raises():
    cfg = get_arch("qwen3-8b").smoke
    params = T.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for shape, groups in (((1, 2, 1), {}), ((2, 2, 1), {}),
                          ((2, 1, 2), {"model": object()})):
        with pytest.raises(RuntimeError, match="no process group"):
            ServeEngine(params, cfg, SP, ServeConfig(packed=True, **SERVE),
                        device="cpu",
                        mesh=Mesh(dict(zip(AXES, shape)), 0, groups))


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


# ---------------------------------------------------------------------------
# (e) slot lanes over the DP axes, with no ranks
# ---------------------------------------------------------------------------


def test_slot_blocks_and_the_dp_group_order():
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.launch import spmd as JS

    def blocks(n, shape):
        return [tp.slot_block(n, Mesh(dict(zip(AXES, shape)), r))
                for r in range(math.prod(shape))]

    assert blocks(4, (2, 2, 1)) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert blocks(8, (1, 2, 2)) == [(0, 4), (0, 4), (4, 8), (4, 8)]
    assert blocks(4, (2, 1, 2)) == [(0, 2), (0, 2), (2, 4), (2, 4)]
    # D does not divide the slots: every rank holds every one, as the
    # reference's _sanitize_pspec replicates the axis
    for n, shape in ((3, (2, 2, 1)), (6, (2, 2, 1)), (3, (1, 2, 2))):
        assert set(blocks(n, shape)) == {(0, n)}
        assert JS._sanitize_pspec(P(("pod", "data")), (n,), AbstractMesh(
            shape, AXES)) == P(None)
    shape = dict(zip(AXES, (2, 2, 2)))
    assert [Mesh(shape, r).dp_index for r in range(8)] == [0, 0, 1, 1, 2, 2,
                                                           3, 3]
    assert axis_ranks(shape, DP_AXES) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert axis_ranks(shape, "data") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    split = tp.SlotSplit(None, 4, 1, 8, 2, 4)
    assert (split.holds(3), split.holds(4), split.owner(5),
            split.replicated) == (True, False, 2, False)
    assert tp.SlotSplit(None, 4, 1, 3, 0, 3).owner(2) == 1
    assert tp.slot_split(Mesh(dict(zip(AXES, (1, 1, 2)))), 4) is None


# ---------------------------------------------------------------------------
# (f) build_lm_serve's shared pack, with no ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,size", [("qwen3-8b", "smoke"),
                                       ("qwen3-8b", "full"),
                                       ("glm4-9b", "smoke")])
def test_shared_pack_specs_equal_the_reference(arch, size):
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_arch as ref_arch
    from repro.core import bdwp as JB
    from repro.core.sparsity import SparsityConfig as JSparsity
    from repro.models import transformer_lm as JT
    from repro.sharding import rules as JR

    jcfg, pcfg = getattr(ref_arch(arch), size), getattr(get_arch(arch), size)
    jsp = JSparsity(2, 8, "bdwp")
    aparams, specs = JT.init(jax.random.PRNGKey(0), jcfg, abstract=True)
    for shape in PLAN_MESHES:
        jmesh = AbstractMesh(shape, AXES)
        ref = JB.pack_tree_shared(aparams, jsp, pspecs=JR.nm_params_pspecs(
            specs, JR.SERVE_BATCH_RULES, aparams, jmesh, jsp))[1]
        mine = ST.build_lm_serve(pcfg, Mesh(dict(zip(AXES, shape))), SP, {},
                                 packed=True).state_shardings
        assert _check_specs(mine, ref, "blocks") == len(tp.leaf_shapes(
            T.abstract_params(pcfg)))
        assert sum(isinstance(op, SharedOp) for _, _, op in _port_leaves(
            mine)) == 7 * pcfg.n_layers


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_rank_shared_blocks_are_the_whole_packs_blocks(shape):
    """Pack whole, then cut: a column block (q/k/v, w_gate, w_up) is
    bitwise the whole pack's columns with its rows whole; a row block
    (o_proj, w_down) is the whole pack's rows, its rebased rows plus
    r K / M bitwise the whole's, all in [0, K / M)."""
    cfg = get_arch("qwen3-8b").smoke
    params = T.init(cfg, seed=1, device="cpu", dtype=torch.bfloat16)
    whole = TB.pack_tree_shared(params, SP, device="cpu")
    m = shape[2]
    kinds = {"col": 0, "row": 0}
    for rank in range(math.prod(shape)):
        mesh = Mesh(dict(zip(AXES, shape)), rank)
        r = mesh.coord("model")
        specs = ST.build_lm_serve(cfg, mesh, SP, {},
                                  packed=True).state_shardings
        mine = tp.serve_blocks(whole, specs, mesh)
        for (path, _, a), (_, _, w) in zip(_port_leaves(mine),
                                           _port_leaves(whole)):
            if not isinstance(w, SharedOp):
                continue
            kc, f = w.vals.shape
            if a.vals.shape == (kc, f // m):
                cols = slice(r * f // m, (r + 1) * f // m)
                assert torch.equal(a.vals, w.vals[:, cols]), path
                assert torch.equal(a.idx, w.idx) and a.k == w.k, path
                kinds["col"] += 1
            else:
                assert a.vals.shape == (kc // m, f), path
                rows = slice(r * kc // m, (r + 1) * kc // m)
                assert torch.equal(a.vals, w.vals[rows]), path
                assert a.k == w.k // m, path
                assert torch.equal(a.idx + r * a.k, w.idx[rows]), path
                assert 0 <= int(a.idx.min()) and int(a.idx.max()) < a.k
                kinds["row"] += 1
    n = cfg.n_layers * math.prod(shape)
    assert kinds == {"col": 5 * n, "row": 2 * n}


@pytest.mark.parametrize("model", [2, 4])
def test_row_parallel_shared_partial_products_sum_to_the_whole(model):
    """nm_apply_f32 of each rank's row block on its columns of x, summed
    over the M blocks: the whole SharedOp's fp32 product (another order
    of the same fp32 sums)."""
    gen = torch.Generator().manual_seed(0)
    k, f = 128, 48
    w = torch.randn((k, f), generator=gen).to(torch.bfloat16)
    x = torch.randn((3, k), generator=gen).to(torch.bfloat16)
    op = SharedOp(*TB.shared_ff_pack(w, SP), k)
    whole = O.nm_apply_f32(op, x)
    spec = {"w": SharedOp(("model", None), ("model",))}
    total = torch.zeros_like(whole)
    for r in range(model):
        blk = tp.serve_blocks({"w": op}, spec,
                              Mesh({"data": 1, "model": model}, r))["w"]
        total += O.nm_apply_f32(blk, x[:, r * k // model:(r + 1) * k // model])
    bound = 1e-5 * (x.float().abs() @ w.float().abs())
    assert ((total - whole).abs() <= bound).all()
    # a pattern whose rows leave the rank's K block is refused, not read
    bad = SharedOp(op.vals, op.idx.flip(0), k)
    with pytest.raises(ValueError, match="rebased rows"):
        tp.serve_blocks({"w": bad}, spec, Mesh({"data": 1, "model": model},
                                                1))
