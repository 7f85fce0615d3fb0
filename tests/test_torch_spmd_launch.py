"""The port's mesh execution end to end, on the CPU:

1. The launcher at ``--mesh pod=2,data=2 --compress --device cpu``
   (``torchrun``, four gloo processes, qwen3-8b SMOKE, 3 steps) prints
   the mesh as the reference's launcher does, and two runs print the
   same losses and fingerprints (the gathered state, every rank's
   residual row): bitwise deterministic.
2. One spawn of four ranks at pod=2, data=2 (file-store init):
   * the compressed sync of each rank's blocks with its residual block
     is bitwise the rank's slice of the one-process sync of the whole
     gradients (mean and residual), and the hop carries ``wire_bytes``
     of the rank's blocks;
   * a checkpoint saved at data=2 restores in one process (data=1),
     which saves it again, and that one restores at data=2 bitwise,
     the residual's columns moved both ways; both checkpoints hold the
     same bits;
   * ``restore_with_pregen`` from a checkpoint without a compute tree
     gives every rank the slice of a fresh ``pregen_tree``.
3. ``restore_with_pregen`` upgrades both older generations (no compute
   tree; expert stacks as plain bf16 copies) to bitwise a fresh
   ``pregen_tree`` (granite-moe-1b-a400m SMOKE), and refuses a
   checkpoint of another structure.
4. whisper SMOKE through ``build_encdec_train`` on the same mesh
   tracks the one-process step (losses 2e-3, master 1e-3); granite-moe
   SMOKE through ``build_lm_train`` with the compressed sync routes
   each pod's batch in groups across its data ranks: the losses and
   aux of the one-process step of both pods.
5. A "model" axis of more than one rank raises NotImplementedError
   naming ROADMAP item 7, part 3 (``--model-parallel 2``, ``--mesh
   data,model=2``, ``build_lm_train``).
"""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_arch
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_stream
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import compress as C
from repro_torch.optim import sgd
from repro_torch.sharding import fsdp as F
from repro_torch.train import step as ST
from repro_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
SP = SparsityConfig(n=2, m=8, method="bdwp")
OPT = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
CFG = get_arch("qwen3-8b").smoke
PODS, DATA = 2, 2
WORLD = PODS * DATA
ARGS = ["--arch", "qwen3-8b", "--steps", "3", "--batch", "8", "--seq", "32",
        "--mesh", "pod=2,data=2", "--compress", "--device", "cpu",
        "--digest", "--log-every", "1"]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _same_trees(a, b):
    fa, fb = F.tensors(a), F.tensors(b)
    return len(fa) == len(fb) > 0 and all(
        _equal(x, y) for x, y in zip(fa, fb))


def _whole_grads(compute):
    """Pod-stacked (2, ...) gradients of the compute tree's dtypes."""
    g = torch.Generator().manual_seed(11)
    per = [sgd.pregen_grads(compute, [
        (torch.randn(x.shape, generator=g) * 1e-2).to(x.dtype)
        for x in sgd.diff_leaves(compute)]) for _ in range(PODS)]
    return sgd.tree_map(lambda _, *xs: torch.stack(xs), *per)


def _whole_err(width):
    return torch.randn((PODS, width),
                       generator=torch.Generator().manual_seed(12)) * 1e-3


def _worker(rank, store, out_dir):
    import torch.distributed as dist

    from repro_torch.launch import spmd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    from repro_torch.launch.mesh import make_host_mesh, mesh_chips

    mesh = spmd.make_spmd_mesh("pod=2,data=2")
    bundle = ST.build_lm_train(CFG, mesh, SP, OPT, compress=True)
    sh = bundle.state_shardings
    p, d = mesh.coord("pod"), mesh.coord("data")
    host = make_host_mesh(pods=2)
    out = {"coords": (p, d), "host": (dict(host.shape), host.coords,
                                      mesh_chips(host),
                                      sorted(host.groups, key=str))}
    # the sync of this rank's blocks
    whole = ST.init_train_state(CFG, SP, device="cpu", compress=True,
                                n_pods=PODS)
    grads = _whole_grads(whole["compute"])
    mine = F.shard_tree(sgd.tree_map(lambda _, x: x[p], grads),
                        sh.specs["master"], mesh)
    err = F.err_block(_whole_err(whole["err"].shape[1])[p:p + 1],
                      sh.err_layout(), DATA, d)
    C.reset_hop_stats()
    mean, new_err = C.cross_pod_sync(
        sgd.tree_map(lambda _, x: x[None], mine), err,
        C.GradCompressConfig.from_sparsity(SP), group=mesh.group("pod"))
    out["sync"] = (mean, new_err, dict(C.hop_stats), mine)
    # checkpoints: save at data=2, one process at data=1, back at data=2
    state = bundle.init_state(CFG, SP, device="cpu", compress=True)
    stream = lm_stream(CFG.vocab, 8, 32, device="cpu",
                       rows=(p * DATA + d, WORLD))
    state, _ = bundle.step_fn(state, next(stream)[1])
    dir_a, dir_b, dir_c = (os.path.join(out_dir, k) for k in "abc")
    CheckpointManager(dir_a, shardings=sh).save(1, state, blocking=True)
    if rank == 0:
        like = ST.init_train_state(CFG, SP, device="cpu", compress=True,
                                   n_pods=PODS)
        one = CheckpointManager(dir_a).restore(like, device="cpu")
        CheckpointManager(dir_b).save(1, one, blocking=True)
        CheckpointManager(dir_c).save(1, {k: v for k, v in one.items()
                                          if k != "compute"},
                                      blocking=True)
        out["one"] = one
    dist.barrier()
    back = CheckpointManager(dir_b, shardings=sh).restore(state,
                                                          device="cpu")
    out["reshard"] = (_same_trees(back, state),
                      _equal(back["err"], state["err"]),
                      back["step"] == state["step"] == 1,
                      float(state["err"].abs().sum()))
    up = ST.restore_with_pregen(CheckpointManager(dir_c, shardings=sh),
                                state, shardings=sh, sp_cfg=SP,
                                device="cpu")
    fresh = F.shard_tree(sgd.pregen_tree(
        F.gather_tree(state["master"], sh.specs["master"], mesh), SP,
        pack=True), sh.specs["compute"], mesh)
    out["upgrade"] = (_same_trees(up["compute"], fresh),
                      _same_trees(up["master"], state["master"]),
                      _equal(up["err"], state["err"]))
    out["encdec"] = _encdec_run(mesh, rank)
    out["moe"] = _moe_run(mesh, rank)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


W_CFG = get_arch("whisper-large-v3").smoke
W_ROWS = (8, 16, 16)          # rows, tokens, frames


def _encdec_run(mesh=None, rank=0):
    """Two steps of whisper SMOKE: ``build_encdec_train`` on ``mesh``
    (FSDP over "data", the dense mean over "pod"), each rank on its row
    block, or the one-process step on every row; (losses, master)."""
    from repro_torch.data.synthetic import encdec_stream

    rows, seq, frames = W_ROWS
    if mesh is None:
        step = functools.partial(ST.encdec_train_step, cfg=W_CFG, sp_cfg=SP,
                                 opt_cfg=OPT)
        state = ST.init_train_state(W_CFG, SP, device="cpu")
        block = None
    else:
        bundle = ST.build_encdec_train(W_CFG, mesh, SP, OPT)
        step = bundle.step_fn
        state = bundle.init_state(W_CFG, SP, device="cpu")
        block = (rank, mesh.size)
    data = encdec_stream(W_CFG.vocab, rows, seq, W_CFG.d_model,
                         enc_frames=frames, device="cpu", rows=block)
    losses = []
    for _ in range(2):
        state, met = step(state, next(data)[1])
        losses.append(float(met["loss"]))
    master = state["master"] if mesh is None else F.gather_tree(
        state["master"], bundle.state_shardings.specs["master"], mesh)
    return losses, master


M_CFG = get_arch("granite-moe-1b-a400m").smoke


def _moe_run(mesh=None, rank=0):
    """Two compressed steps of granite-moe SMOKE, 8 x 32 tokens: on
    ``mesh`` each rank on its 64 tokens, its pod's 128 one routing group
    across the pod's two data ranks; else the one-process step of both
    pods.  Both steps read the initial master (lr 0 at step 0): (losses,
    aux)."""
    if mesh is None:
        step = functools.partial(ST.lm_train_step, cfg=M_CFG, sp_cfg=SP,
                                 opt_cfg=OPT, compress=True, n_pods=PODS)
        state = ST.init_train_state(M_CFG, SP, device="cpu", compress=True,
                                    n_pods=PODS)
        block = None
    else:
        bundle = ST.build_lm_train(M_CFG, mesh, SP, OPT, compress=True)
        step = bundle.step_fn
        state = bundle.init_state(M_CFG, SP, device="cpu", compress=True)
        block = (rank, mesh.size)
    data = lm_stream(M_CFG.vocab, 8, 32, device="cpu", rows=block)
    losses, aux = [], []
    for _ in range(2):
        state, met = step(state, next(data)[1])
        losses.append(float(met["loss"]))
        aux.append(float(met["aux"]))
    return losses, aux


def test_moe_on_the_pod_data_mesh_routes_each_pods_batch(ranks):
    """granite-moe at pod=2, data=2 with the compressed sync: each pod's
    routing groups and load-balance loss span its two data ranks (as
    the reference's step, one program a pod), so the losses and aux of
    the steps that read the initial master are those of the one-process
    step of the two pods, to the order of the ranks' sums."""
    import numpy as np

    _, _, got = ranks
    want_losses, want_aux = _moe_run()
    for out in got:
        losses, aux = out["moe"]
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-5)
        np.testing.assert_allclose(aux, want_aux, rtol=0, atol=1e-5)
    assert min(want_aux) > 0


def test_mesh_coordinates_and_groups(ranks):
    """Rank r of pod=2, data=2 sits at (pod, data) = divmod(r, 2), as the
    reference's reshape of its devices; ``make_host_mesh(pods=2)`` over
    the four ranks is (pod 2, data 2, model 1) with a "pod", a "data"
    and a DP group (both axes); one process without a group is a
    one-rank mesh."""
    from repro_torch.launch.mesh import DP_AXES, make_host_mesh, mesh_chips

    _, _, got = ranks
    for r, out in enumerate(got):
        assert out["coords"] == divmod(r, DATA)
        shape, coords, chips, groups = out["host"]
        assert shape == {"pod": 2, "data": 2, "model": 1} and chips == 4
        assert coords == {"pod": r // 2, "data": r % 2, "model": 0}
        assert groups == [DP_AXES, "data", "pod"]
    one = make_host_mesh()
    assert dict(one.shape) == {"data": 1, "model": 1} and not one.groups
    assert mesh_chips(one) == 1


def _launch(cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train",
         *ARGS], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    procs = [_launch(d) for _ in range(2)]
    mp.spawn(_worker, args=(str(d / "store"), str(d)), nprocs=WORLD)
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        outs.append(out)
    return d, outs, [torch.load(d / f"rank{r}.pt", weights_only=False)
                     for r in range(WORLD)]


def _digest(out):
    """The digest's lines without the step times (the host's clock)."""
    keep = ("losses", "fingerprint", "rank ")
    return sorted(re.sub(r"step_ms \[[^]]*\] ", "", line)
                  for line in out.splitlines() if line.startswith(keep))


def test_launcher_on_pod_data_mesh_is_deterministic(ranks):
    _, outs, _ = ranks
    assert "mesh {'pod': 2, 'data': 2} | qwen3-8b (smoke)" in outs[0]
    assert "compressed pod sync (topk)" in outs[0]
    assert "done: 3 steps" in outs[0]
    one, two = _digest(outs[0]), _digest(outs[1])
    assert one == two
    assert sum(line.startswith("rank ") for line in one) == WORLD
    losses = [float(x) for x in re.findall(r"loss (\d+\.\d+) ", outs[0])]
    assert len(losses) == 3 and all(0 < x < 20 for x in losses)


def test_sync_blocks_are_slices_of_the_one_process_sync(ranks):
    _, _, got = ranks
    whole = ST.init_train_state(CFG, SP, device="cpu", compress=True,
                                n_pods=PODS)
    grads = _whole_grads(whole["compute"])
    mean, new_err = C.cross_pod_sync(grads, _whole_err(whole["err"].shape[1]),
                                     C.GradCompressConfig.from_sparsity(SP))
    mesh_shape = {"pod": PODS, "data": DATA}
    specs = ST.state_pspecs(CFG, Mesh(mesh_shape), SP, compress=True)
    for r, out in enumerate(got):
        rmesh = Mesh(mesh_shape, rank=r)
        sh = F.StateSharding(rmesh, specs, sgd.shapes_of(whole["master"]),
                             SP.m)
        p, d = out["coords"]
        g_mean, g_err, hop, mine = out["sync"]
        assert _same_trees(g_mean, F.shard_tree(mean, specs["master"],
                                                rmesh))
        assert _equal(g_err, F.err_block(new_err[p:p + 1], sh.err_layout(),
                                         DATA, d))
        plan = C.plan_for(mine, 8, 8)
        total = sum(n for _, _, n in plan.units)
        ragged = sum(x.numel() for x, off in zip(sgd.tree_leaves(mine),
                                                 plan.offsets) if off is None)
        assert hop["bytes_sent"] == C.wire_bytes(
            total, ragged, C.GradCompressConfig.from_sparsity(SP))
        assert sh.err_layout().local_width == g_err.shape[1] \
            < new_err.shape[1]


def _files(d):
    import json

    man = json.load(open(d / "manifest.json"))
    return [(torch.load(d / f"leaf_{i:05d}.pt") if x["kind"] == "tensor"
             else x) for i, x in enumerate(man["leaves"])]


def test_checkpoint_reshards_data_2_1_2_bitwise(ranks):
    d, _, got = ranks
    for out in got:
        same_state, same_err, same_step, err_mass = out["reshard"]
        assert same_state and same_err and same_step and err_mass > 0
    a, b = _files(d / "a" / "step_00000001"), _files(d / "b" /
                                                      "step_00000001")
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert _equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert got[0]["one"]["err"].shape == (PODS, C.err_state_elems(
        got[0]["one"]["master"], SP.m))


def test_restore_with_pregen_on_the_mesh(ranks):
    _, _, got = ranks
    for out in got:
        assert all(out["upgrade"])


def test_restore_with_pregen_upgrades_both_generations(tmp_path):
    cfg = get_arch("granite-moe-1b-a400m").smoke
    state = ST.init_train_state(cfg, SP, seed=1, device="cpu")
    fresh = sgd.pregen_tree(state["master"], SP, pack=True)
    old = sgd.pregen_tree(state["master"], SP, pack=True, bare_sites=False)
    assert not _same_trees(old, fresh)
    gens = {"none": {k: v for k, v in state.items() if k != "compute"},
            "dict_sites": dict(state, compute=old)}
    for name, saved in gens.items():
        mgr = CheckpointManager(str(tmp_path / name))
        mgr.save(0, saved, blocking=True)
        with pytest.raises(ValueError):
            mgr.restore(state, device="cpu")
        up = ST.restore_with_pregen(mgr, state, sp_cfg=SP, device="cpu")
        assert _same_trees(up["compute"], fresh), name
        assert _same_trees(up["master"], state["master"])
    other = ST.init_train_state(CFG, SP, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "other"))
    mgr.save(0, other, blocking=True)
    with pytest.raises(ValueError):
        ST.restore_with_pregen(mgr, state, sp_cfg=SP, device="cpu")


def test_model_axis_raises(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP item 7, part 3"):
        LT.run_training(LT.build_parser().parse_args(
            ["--arch", "qwen3-8b", "--model-parallel", "2", "--device",
             "cpu"]))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP item 7, part 3"):
        LT.run_training(LT.build_parser().parse_args(
            ["--arch", "qwen3-8b", "--mesh", "data,model=2", "--device",
             "cpu"]))
    with pytest.raises(NotImplementedError, match="ROADMAP item 7, part 3"):
        ST.build_lm_train(CFG, Mesh({"data": 1, "model": 2}), SP, OPT)


def test_encdec_on_the_mesh_tracks_one_process(ranks):
    """whisper SMOKE through ``build_encdec_train`` at pod=2, data=2 (the
    dense pod mean: the encoder-decoder has no compressed sync) tracks
    the one-process step on the same rows within the reference's
    sharded-vs-single tolerance (losses 2e-3, master 1e-3)."""
    import numpy as np

    _, _, got = ranks
    want_losses, want_master = _encdec_run()
    losses, master = got[0]["encdec"]
    np.testing.assert_allclose(losses, want_losses, atol=2e-3)
    mine, theirs = sgd.tree_leaves(master), sgd.tree_leaves(want_master)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)
    for out in got[1:]:
        assert out["encdec"][0] == losses
