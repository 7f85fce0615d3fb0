"""FSDP over the mesh's "data" axis (``repro_torch.sharding.fsdp``):

1. In one process, with no group: the update of every rank's blocks
   (``sgd.update`` with the logical shapes) is bitwise the block's slice
   of the unsharded update, for qwen3-8b SMOKE, granite-moe-1b-a400m
   SMOKE (expert stacks cut along K) and whisper-large-v3 SMOKE (both
   block lists), at D = 2 and 4: master, momentum
   and every compute field (bp, packed vals/idx, mask); the sharded
   init is bitwise the cut of the whole one.
2. Two gloo processes at data=2 (one spawn, file-store init) run 3 steps
   of ``build_lm_train`` from the reference's initial state, against the
   reference's own ``build_lm_train`` on a forced 2-device mesh (a
   subprocess, ``tests/jax_fsdp_reference.py``), on the same batches,
   for qwen3-8b SMOKE and granite-moe-1b-a400m SMOKE (MoE routing groups
   that span both ranks): losses agree to 2e-3 and the master to 1e-3,
   the reference's own sharded-vs-single tolerance
   (``tests/test_spmd.py``) at its optimizer, and each master leaf's
   change over the 3 steps to MASTER_MOVE_RTOL of the reference's, in
   norm (the tolerance alone is some 50 times the change); granite's
   load-balance loss to 2e-3; qwen3's same 3 steps run twice are
   bitwise equal; the step gathered and reduced what ``fsdp.stats``
   says.
"""

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
from repro_torch.configs import get_arch
from repro_torch.core.operand import PregenOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import sgd
from repro_torch.sharding import fsdp as F
from repro_torch.train import step as ST
from repro_torch.train import trainer as TR

ROOT = Path(__file__).resolve().parents[1]
SP = SparsityConfig(n=2, m=8, method="bdwp")
OPT = sgd.SGDConfig(lr=0.1, total_steps=8)     # tests/test_spmd.py's
UPD = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
ARCH, BATCH, SEQ, STEPS, D = "qwen3-8b", 8, 32, 3, 2
ARCHS = (ARCH, "granite-moe-1b-a400m")
MASTER_MOVE_RTOL = 2e-2


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _flat(tree):
    return F.tensors(tree)


def _grads(compute, seed):
    g = torch.Generator().manual_seed(seed)
    return sgd.pregen_grads(compute, [
        (torch.randn(x.shape, generator=g) * 1e-2).to(x.dtype)
        for x in sgd.diff_leaves(compute)])


def _clone(tree):
    return F.map_blocks(tree, tree, lambda t, _: t.clone())


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("parts", [2, 4])
def test_sharded_update_is_a_slice_of_the_whole(arch, parts):
    cfg = get_arch(arch).smoke
    whole = ST.init_train_state(cfg, SP, seed=3, device="cpu")
    whole["step"] = 5
    grads = _grads(whole["compute"], 7)
    mesh = Mesh({"pod": 1, "data": parts, "model": 1})
    specs = ST.state_pspecs(cfg, mesh, SP)
    lshapes = sgd.shapes_of(whole["master"])
    cut_dims = [F.shard_dim(s, mesh) for s in
                sgd.tree_leaves(specs["master"])]
    assert sum(d is not None for d in cut_dims) > len(cut_dims) // 2
    if arch.startswith("granite"):   # expert stacks cut along K
        assert specs["master"]["blocks"][0]["moe"]["w_gate"][1] == "data"
    blocks = [F.StateSharding(Mesh(mesh.shape, rank=r), specs, lshapes,
                              SP.m).shard(_clone(whole))
              for r in range(parts)]
    block_grads = [F.shard_tree(grads, specs["master"],
                                Mesh(mesh.shape, rank=r))
                   for r in range(parts)]
    new, comp = sgd.update(ST.state_core(_clone(whole)), grads, UPD, SP,
                           prev_compute=whole["compute"], pack=True)
    want = {"master": new["master"], "momentum": new["momentum"],
            "compute": comp}
    n_sites = sum(isinstance(x, PregenOp)
                  for x in sgd.tree_leaves(comp))
    assert n_sites > 0
    for r in range(parts):
        rmesh = Mesh(mesh.shape, rank=r)
        got, gcomp = sgd.update(ST.state_core(blocks[r]), block_grads[r],
                                UPD, SP, prev_compute=blocks[r]["compute"],
                                pack=True, lshapes=lshapes)
        for key, tree in (("master", got["master"]),
                          ("momentum", got["momentum"]),
                          ("compute", gcomp)):
            slices = _flat(F.shard_tree(want[key], specs[key], rmesh))
            mine = _flat(tree)
            assert len(slices) == len(mine)
            assert all(_equal(a, b) for a, b in zip(slices, mine)), \
                (arch, parts, r, key)
        fresh = ST.init_train_state(cfg, SP, seed=3, device="cpu",
                                    mesh=rmesh)
        cut = F.StateSharding(rmesh, specs, lshapes, SP.m).shard(
            ST.init_train_state(cfg, SP, seed=3, device="cpu"))
        assert all(_equal(a, b) for a, b in zip(_flat(fresh), _flat(cut)))


def _port_state(ref_init):
    return convert.train_state_from_jax(ref_init, device="cpu")


def _run(bundle, state, rank, arch):
    stream = lm_stream(get_arch(arch).smoke.vocab, BATCH, SEQ, device="cpu",
                       rows=(rank, D))
    F.reset_stats()
    state, hist = TR.train_steps(bundle, state, stream, STEPS)
    stats = dict(F.stats)
    return (bundle.state_shardings.gather(state),
            [float(h["loss"]) for h in hist], stats,
            [float(h["aux"]) for h in hist])


def _worker(rank, store, out_dir, ref_init):
    import torch.distributed as dist

    from repro_torch.launch import spmd

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=D)
    mesh = spmd.make_spmd_mesh(f"data={D}")
    runs = {}
    for arch in ARCHS:   # the first twice: run to run
        bundle = ST.build_lm_train(get_arch(arch).smoke, mesh, SP, OPT)
        whole = _port_state(ref_init[arch])
        runs[arch] = [_run(bundle, bundle.state_shardings.shard(
            _clone(whole)), rank, arch) for _ in range(2 if arch == ARCH
                                                       else 1)]
    if rank == 0:
        torch.save(runs, os.path.join(out_dir, "runs.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={D}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    dst = d / "ref.pkl"
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_fsdp_reference.py"),
         str(dst), str(BATCH), str(SEQ), str(STEPS), *ARCHS], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    init = Path(f"{dst}.init")
    start = time.monotonic()
    while not init.exists():   # the reference writes it before training
        assert proc.poll() is None, proc.stderr.read()[-4000:]
        assert time.monotonic() - start < 300
        time.sleep(0.2)
    with open(init, "rb") as f:  # written whole, then renamed into place
        ref_init = pickle.load(f)
    mp.spawn(_worker, args=(str(d / "store"), str(d), ref_init), nprocs=D)
    _, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-4000:]
    with open(dst, "rb") as f:
        ref = pickle.load(f)
    return ref, torch.load(d / "runs.pt", weights_only=False)


def _track_the_reference(ref, run):
    """Losses within 2e-3 and the master within 1e-3 of the reference's
    (its own sharded-vs-single tolerance), and each master leaf's change
    over the steps within MASTER_MOVE_RTOL of the reference's change, in
    norm: at the tolerance's optimizer the master moves far less than
    1e-3, so the change is what shows a wrong gradient."""
    state, losses = run[0], run[1]
    np.testing.assert_allclose(losses, ref["losses"], atol=2e-3)
    want = convert.params_from_jax(ref["final"]["master"], device="cpu")
    init = convert.params_from_jax(ref["init"]["master"], device="cpu")
    mine, theirs = sgd.tree_leaves(state["master"]), sgd.tree_leaves(want)
    assert len(mine) == len(theirs)
    for a, b, x in zip(mine, theirs, sgd.tree_leaves(init)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)
        moved = (b - x).norm()
        assert moved > 0
        assert (a - b).norm() <= MASTER_MOVE_RTOL * moved
    assert state["step"] == STEPS == int(ref["final"]["step"])


def test_two_ranks_track_the_reference_sharded_step(runs):
    ref, got = runs
    _track_the_reference(ref[ARCH], got[ARCH][0])


def test_moe_routes_over_the_whole_batch(runs):
    """granite-moe at data=2, 128 tokens a rank in routing groups of the
    whole batch's 256: each rank's queues continue the rank's ahead, and
    the load-balance loss takes every rank's probabilities and counts,
    as the reference's one program over the batch does."""
    ref, got = runs
    moe = ARCHS[1]
    _track_the_reference(ref[moe], got[moe][0])
    np.testing.assert_allclose(got[moe][0][3], ref[moe]["aux"], atol=2e-3)
    assert ref[moe]["aux"][0] > 0


def test_two_runs_are_bitwise_equal(runs):
    _, got = runs
    (a, la, sa, xa), (b, lb, sb, xb) = got[ARCH]
    assert la == lb and sa == sb and xa == xb
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb) > 0
    assert all(_equal(x, y) for x, y in zip(fa, fb))


def test_step_gathers_and_reduces(runs):
    """Each step gathers every cut leaf the model reads (a site's bp and
    packed vals/idx, not its decay mask) in the forward and every cut
    block leaf again in its recompute, the untied embedding table's rows
    of the batch's tokens once (not the table), and reduces every float
    leaf's gradient once."""
    _, got = runs
    state, _, stats, _ = got[ARCH][0]
    mesh = Mesh({"data": D, "model": 1})
    specs = ST.state_pspecs(get_arch(ARCH).smoke, mesh, SP)
    assert not get_arch(ARCH).smoke.tie_embed
    pairs = F._pairs(state["compute"], specs["compute"], [], F.READ_FIELDS)
    cut = [F.shard_dim(s, mesh) is not None for _, s in pairs]
    in_blocks = F._pairs(state["compute"]["blocks"],
                         specs["compute"]["blocks"], [], F.READ_FIELDS)
    cut_blocks = sum(F.shard_dim(s, mesh) is not None for _, s in in_blocks)
    assert F.shard_dim(specs["compute"]["embed"]["embed_table"], mesh) == 1
    # the table's row gather takes the place of its whole gather
    assert stats["gathers"] == STEPS * (sum(cut) + cut_blocks)
    assert stats["reductions"] == STEPS * len(
        sgd.diff_leaves(state["compute"]))
    assert stats["gather_bytes"] > 0 and stats["reduce_bytes"] > 0
