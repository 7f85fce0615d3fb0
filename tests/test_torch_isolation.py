"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

* An AST scan of every module of ``src/repro_torch/``, of the port's
  examples (``examples/torch_*.py``) and of ``chip_smoke.py`` finds no import of ``jax``, ``jaxlib`` or the
  reference package ``repro``.
* The entry points (``ServeEngine``, ``init``, ``pack_tree_element``
  (for deepseek-v2-lite's MLA and prelude too, and for mamba2's and
  hymba's SSD blocks and their fp32 caches, and for whisper's
  encoder-decoder),
  ``pack_tree_shared``,
  ``params_from_jax``, ``init_train_state`` with and without the
  compressed sync's residual (and so the state that ``lm_train_step``
  and ``cross_pod_sync`` take), ``train_state_from_jax``,
  ``err_from_jax``, ``lm_stream``, ``encdec_stream``, the
  encoder-decoder's ``init`` and train state, ``CheckpointManager.restore`` and
  ``recover_or_init``, and for the paper's image models
  ``convnets.init``, ``init_image_train_state``, ``image_batch`` and
  ``image_stream``, and the serving fleet: ``ServeFleet``,
  ``replica_device_groups``, ``fleet_meshes`` and
  ``examples/torch_serve_decode.py``) run on the card unless the caller
  names a device;
  with no card they raise instead of falling back to the CPU.
"""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro_torch import convert
from repro_torch.configs import paper_models as PM
from repro_torch.configs import qwen3_8b as TC
from repro_torch.core import bdwp
from repro_torch.core.operand import PregenOp, SharedOp
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data import synthetic as TD
from repro_torch.data.synthetic import lm_stream
from repro_torch.models import convnets as CN
from repro_torch.models import transformer_lm as T
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.packed_params import pack_tree_element
from repro_torch.train import fault as TF
from repro_torch.train import step as ST
from repro_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return (files + sorted((ROOT / "examples").glob("torch_*.py"))
            + [ROOT / "chip_smoke.py"])


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in _sources()}
    assert {"nm_spmm.py", "engine.py", "chip_smoke.py", "fused_update.py",
            "sgd.py", "trainer.py", "synthetic.py", "grad_compress.py",
            "compress.py", "checkpoint.py", "fault.py", "nm_compact.py",
            "nm_spmm_shared.py"} <= names


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = T.init(TC.SMOKE, seed=0, device="cpu", dtype=torch.bfloat16)
    sp = SparsityConfig(n=2, m=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, TC.SMOKE, sp, ServeConfig(packed=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(TC.SMOKE, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_tree_element(params, sp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax({"blocks": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.init_train_state(TC.SMOKE, sp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.init_train_state(TC.SMOKE, sp, compress=True, n_pods=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.train_state_from_jax({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.err_from_jax(torch.zeros(2, 8).numpy(), {"w": params[
            "final_norm"]["norm_scale"][:8]}, 8)
    state = ST.train_state_from_params(
        T.init(TC.SMOKE, seed=0, device="cpu"), sp, compress=True, n_pods=2)
    assert state["err"].device.type == "cpu"
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.recover_or_init(mgr, lambda: state)
    assert mgr.restore(state, device="cpu")["err"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_stream(TC.SMOKE.vocab, 2, 8)
    assert next(lm_stream(TC.SMOKE.vocab, 2, 8, device="cpu"))[1][
        "tokens"].device.type == "cpu"
    eng = ServeEngine(params, TC.SMOKE, sp, ServeConfig(packed=True),
                      device="cpu")
    assert eng.device.type == "cpu"


def test_pack_tree_shared_refuses_to_fall_back_to_cpu(monkeypatch):
    """The shared-pattern pack runs on the card unless a device is named;
    with no card it raises, and with ``device="cpu"`` every leaf is
    there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = T.init(TC.SMOKE, seed=0, device="cpu", dtype=torch.bfloat16)
    sp = SparsityConfig(n=2, m=8, granularity="shared")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bdwp.pack_tree_shared(params, sp)
    packed = bdwp.pack_tree_shared(params, sp, device="cpu")
    op = packed["blocks"][0]["attn"]["q_proj"]["w"]
    assert isinstance(op, SharedOp) and op.vals.device.type == "cpu"


def test_scan_sees_the_image_models():
    names = {p.name for p in _sources()}
    assert {"convnets.py", "paper_models.py", "step.py"} <= names


def test_scan_sees_the_archs_and_examples():
    names = {p.name for p in _sources()}
    assert {"base.py", "qwen2_5_32b.py", "glm4_9b.py", "gemma3_12b.py",
            "internvl2_26b.py", "torch_paper_loss_curves.py",
            "granite_moe_1b.py", "moe.py", "deepseek_v2_lite.py",
            "attention.py", "transformer_lm.py", "batcher.py"} <= names


def test_deepseek_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """deepseek-v2-lite (MLA, a prelude, shared experts): init, the
    layer-by-layer draws, the train state, the element pack and the
    engine run on the card unless a device is named, and raise without
    one; with ``device="cpu"`` the prelude and its cache are there."""
    from repro_torch.configs import deepseek_v2_lite as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, sp = D.SMOKE, SparsityConfig(n=2, m=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.init_train_state(cfg, sp)
    params = T.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert params["prelude"]["attn"]["kv_down"]["w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_tree_element(params, sp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, sp, ServeConfig(packed=True))
    eng = ServeEngine(params, cfg, sp, ServeConfig(packed=True, max_len=16,
                                                   prompt_bucket=8),
                      device="cpu")
    assert eng.device.type == "cpu"
    cache = T.init_lm_cache(cfg, 2, 8, device="cpu")
    assert cache["prelude"]["ckv"].device.type == "cpu"


def test_scan_sees_the_ssm_modules():
    names = {p.name for p in _sources()}
    assert {"ssm.py", "mamba2_370m.py", "hymba_1_5b.py"} <= names


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, arch):
    """mamba2 and hymba: init, the train state, the element pack, the
    engine and the SSD block's cache run on the card unless a device is
    named, and raise without one; with ``device="cpu"`` the SSD block's
    leaves and its fp32 cache are there."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm as S

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, sp = get_arch(arch).smoke, SparsityConfig(n=2, m=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.init_train_state(cfg, sp)
    params = T.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert params["blocks"][0]["ssm"]["conv_w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_tree_element(params, sp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, sp, ServeConfig(packed=True))
    eng = ServeEngine(params, cfg, sp, ServeConfig(packed=True, max_len=16,
                                                   prompt_bucket=8),
                      device="cpu")
    assert eng.device.type == "cpu"
    cache = T.init_lm_cache(cfg, 2, 8, device="cpu")
    assert cache["layers"][0]["state"].device.type == "cpu"
    assert cache["layers"][0]["state"].dtype == torch.float32
    assert S.init_ssm_cache(cfg.ssm_cfg(), 1, device="cpu")[
        "conv"].device.type == "cpu"


def test_scan_sees_the_encdec_modules():
    names = {p.name for p in _sources()}
    assert {"encdec.py", "whisper_large_v3.py"} <= names


def test_encdec_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """whisper (the encoder-decoder): init, the train state, the data,
    the element pack and the parameter conversion run on the card unless
    a device is named, and raise without one; with ``device="cpu"`` both
    block lists and the cache are there, and the prefill and decode
    steps run there."""
    from repro_torch.configs import whisper_large_v3 as W
    from repro_torch.models import encdec as E

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, sp = W.SMOKE, SparsityConfig(n=2, m=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.init_train_state(cfg, sp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.encdec_stream(cfg.vocab, 2, 8, cfg.d_model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax({"enc_blocks": {}, "dec_blocks": {}})
    params = E.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert params["enc_blocks"][0]["ffn"]["w_in"]["b"].device.type == "cpu"
    assert params["dec_blocks"][1]["xattn"]["k_proj"]["w"].device.type == \
        "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_tree_element(params, sp)
    state = ST.init_train_state(cfg, sp, device="cpu")
    assert all(t.device.type == "cpu" for t in _tensors(state["compute"]))
    _, batch = next(TD.encdec_stream(cfg.vocab, 2, 8, cfg.d_model,
                                     enc_frames=16, device="cpu"))
    assert batch["frames"].device.type == "cpu"
    with torch.no_grad():
        logits, cache, enc = ST.encdec_prefill_step(params, batch, cfg=cfg,
                                                    sp_cfg=sp)
        step, _ = ST.encdec_decode_step(params, cache, enc,
                                        batch["tokens"][:, -1:], 8, cfg=cfg,
                                        sp_cfg=sp)
    assert step.device.type == cache["layers"][0]["k"].device.type == "cpu"


@pytest.mark.parametrize("name", ["resnet9", "vgg19", "vit"])
def test_image_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, name):
    """The image models' init, train state and data run on the card
    unless a device is named; with no card they raise, and with
    ``device="cpu"`` everything is there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = PM.image_model(name, width=16)
    if name == "vit":
        model = dataclasses.replace(model, vit=dataclasses.replace(
            model.vit, d_model=32, n_layers=1, n_heads=2, d_ff=64))
    sp = SparsityConfig(n=2, m=8)
    icfg = TD.ImageTaskConfig(image=32, num_classes=model.num_classes,
                              batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CN.init(model, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.init_image_train_state(model, sp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.image_batch(icfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.image_stream(icfg)
    state = ST.init_image_train_state(model, sp, device="cpu")
    assert all(t.device.type == "cpu" for t in _tensors(state))
    images, labels = TD.image_batch(icfg, 0, device="cpu")
    assert images.device.type == labels.device.type == "cpu"


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, PregenOp):
        yield from (t for t in (tree.bp, tree.vals, tree.idx, tree.mask)
                    if t is not None)


def test_scan_sees_the_launch_modules():
    paths = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"src/repro_torch/launch/dist.py",
            "src/repro_torch/launch/train.py"} <= paths


def test_launch_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """The launcher and its process-group helper run on the card unless
    ``--device`` / ``device`` names another, and raise without one."""
    from repro_torch.launch import dist as LD
    from repro_torch.launch import train as LT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LD.rank_device(None, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LD.init_from_env()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.run_training(LT.build_parser().parse_args(
            ["--arch", "qwen3-8b", "--steps", "1"]))
    pods = LD.init_from_env("cpu")
    assert pods.group is None and pods.world == 1
    assert pods.device.type == "cpu"
    assert LD.pick_backend("cpu", 2) == "gloo"


def test_scan_sees_the_sharding_modules():
    paths = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"src/repro_torch/sharding/rules.py",
            "src/repro_torch/sharding/fsdp.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/spmd.py"} <= paths


def test_mesh_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """The sharded train state, a bundle's fresh state, the launcher's
    ``--mesh`` form and a rank's row block of the data run on the card
    unless a device is named, and raise without one; with
    ``device="cpu"`` a rank's blocks are there."""
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.spmd import single_device_mesh
    from repro_torch.optim import sgd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    sp = SparsityConfig(n=2, m=8)
    mesh = Mesh({"data": 2, "model": 1}, rank=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.init_train_state(TC.SMOKE, sp, mesh=mesh)
    bundle = ST.build_lm_train(TC.SMOKE, single_device_mesh(), sp,
                               sgd.SGDConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init_state(TC.SMOKE, sp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.run_training(LT.build_parser().parse_args(
            ["--arch", "qwen3-8b", "--steps", "1", "--mesh", "data"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_stream(TC.SMOKE.vocab, 4, 8, rows=(1, 2))
    state = ST.init_train_state(TC.SMOKE, sp, mesh=mesh, device="cpu")
    assert all(t.device.type == "cpu" for t in _tensors(state["compute"]))
    w = state["master"]["blocks"][0]["attn"]["q_proj"]["w"]
    assert w.shape[0] == TC.SMOKE.d_model // 2


def test_scan_sees_the_fleet_and_the_serve_example():
    paths = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"src/repro_torch/serve/fleet.py",
            "examples/torch_serve_decode.py"} <= paths


def test_fleet_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """The fleet, its device groups and the serving example run on the
    card unless ``device`` / ``devices`` / ``--device`` names another,
    and raise without one; a disaggregated fleet's prefill engines take
    ``device``, so ``devices`` alone does not move them.  With the CPU
    named, every engine is there."""
    from repro_torch.launch import spmd
    from repro_torch.serve import FleetConfig, ServeFleet

    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    import torch_serve_decode as E

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = T.init(TC.SMOKE, seed=0, device="cpu", dtype=torch.bfloat16)
    sp = SparsityConfig(n=2, m=8)
    serve = ServeConfig(packed=True, n_slots=2, max_len=16, prompt_bucket=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeFleet(params, TC.SMOKE, sp, serve, FleetConfig(n_replicas=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeFleet(params, TC.SMOKE, sp, serve,
                   FleetConfig(n_replicas=2, disaggregate=True),
                   devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.replica_device_groups(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.fleet_meshes(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.main(["--tokens", "2"])
    fleet = ServeFleet(params, TC.SMOKE, sp, serve,
                       FleetConfig(n_replicas=2, disaggregate=True),
                       devices=["cpu", "cpu"], device="cpu")
    assert {e.device.type for e in fleet.engines + fleet.prefill_engines} \
        == {"cpu"}
    assert E.main(["--device", "cpu", "--tokens", "4"]) == 0


def test_scan_sees_the_tensor_parallel_module():
    paths = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"src/repro_torch/sharding/tp.py",
            "src/repro_torch/launch/spmd.py"} <= paths


def test_mesh_engine_refuses_to_fall_back_to_cpu(monkeypatch):
    """The tensor-parallel engine and the rank's cache run on the card
    unless ``device`` names another, and raise without one; the mesh
    engine's refusals and the rank store check come after that, and a
    "model" axis without a process group raises instead of serving the
    whole model."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import tp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = T.init(TC.SMOKE, seed=0, device="cpu", dtype=torch.bfloat16)
    sp = SparsityConfig(n=2, m=8)
    serve = ServeConfig(packed=True, n_slots=2, max_len=16, prompt_bucket=8)
    mesh = Mesh({"data": 1, "model": 2})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, TC.SMOKE, sp, serve, mesh=mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, TC.SMOKE, sp, serve,
                    mesh=Mesh({"data": 2, "model": 1}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.init_cache(TC.SMOKE, 2, 16, mesh)
    cache = tp.init_cache(TC.SMOKE, 2, 16, mesh, device="cpu")
    assert {t.device.type for t in _tensors(cache)} == {"cpu"}
    with pytest.raises(RuntimeError, match="no process group"):
        ServeEngine(params, TC.SMOKE, sp, serve, mesh=mesh, device="cpu")
