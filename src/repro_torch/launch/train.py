"""Training launcher CLI of the port.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --steps 50 --method bdwp --nm 2:8 \\
      --ckpt-dir /tmp/run1 [--resume] [--watchdog] [--device cpu]

  # two pods, one process each (gloo on one card or on the CPU)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --steps 8 --compress --device cpu

  # FSDP over two ranks; two pods of two ranks with the compressed sync
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --mesh data=2 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --mesh pod=2,data=2 --compress --device cpu

Counterpart of ``src/repro/launch/train.py``: config -> train state
(fresh, or the newest checkpoint with ``--resume``) -> synthetic data
stream -> ``train.trainer.fit`` (checkpoints, heartbeat, straggler
monitor), with the same flags where they mean the same thing.
``--smoke`` (the default) takes the reduced config, ``--full`` the
published one.  ``--watchdog`` restarts ``-m repro_torch.launch.train``
with ``--resume`` whenever the heartbeat goes stale (``run_watchdog``).

``--mesh`` (the reference's grammar, ``launch.spmd.parse_mesh_spec``)
lays a mesh over the ranks ``torchrun`` started and trains through
``train.step.build_lm_train`` / ``build_encdec_train``: FSDP over
"data", the pod mean over "pod" (compressed with ``--compress``), each
rank on its rows of the global ``--batch``.  Without ``--mesh``, W > 1
processes under ``torchrun`` are the mesh "pod=W" (one pod a process,
the process form of the compressed sync), and one process holds the
``--pods P`` pods of ``--compress`` in one tensor on its device.
``--resume`` restores through ``restore_with_pregen`` onto whatever
mesh is current.

What differs: a "model" axis of more than one rank (``--mesh`` with
model > 1, or ``--model-parallel`` > 1) raises NotImplementedError
(tensor parallelism is ROADMAP item 7, part 3), where the reference
shards over it.  It runs on the card unless ``--device
cpu`` is given, and never falls back to the CPU on its own.  The
encoder-decoder trains without compression, as the reference's
``build_encdec_train`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import subprocess
import sys
import time


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch: the pods split its rows")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--method", default="bdwp",
                    choices=["dense", "srste", "sdgp", "sdwp", "bdwp"])
    ap.add_argument("--nm", default="2:8")
    ap.add_argument("--granularity", default="element",
                    choices=["element", "shared"])
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="N:M cross-pod gradient compression over the "
                         "pods (the process group's, or --pods)")
    ap.add_argument("--grad-estimator", default="topk",
                    choices=["topk", "mvue"],
                    help="gradient sparsifier for --compress: topk with "
                         "error feedback, or the unbiased MVUE sampler "
                         "(arXiv 2203.10991)")
    ap.add_argument("--bucket-elems", type=int, default=1 << 16,
                    help="compressed-sync bucket size in elements "
                         "(must be a multiple of M)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods in one process (all on one device); a "
                         "process group of W > 1 ranks gives W pods "
                         "instead")
    ap.add_argument("--mesh", default=None,
                    help="mesh over the ranks torchrun started, e.g. "
                         "'data=2' (FSDP) or 'pod=2,data=2' (with "
                         "--compress: the compressed pod sync); the "
                         "reference's grammar ('pod,data,model' is "
                         "auto-factored)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the 'model' axis; above 1 raises: "
                         "tensor parallelism is not in the port yet")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run the plain PyTorch path; default: "
                         "the card (a rank's card under torchrun)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers "
                         "(every width kept)")
    ap.add_argument("--digest", action="store_true",
                    help="print the exact losses, a fingerprint of the "
                         "final shared state and of each rank's residual "
                         "row, the kernel launches and the hop's bytes")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms: the MoE "
                         "backward's scatter-adds in a fixed order, so a "
                         "run repeats bit for bit")
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run_training(args) -> int:
    """Train in this process: ``--pods P`` all on its device, or, with
    ``--mesh`` or under a torchrun of W > 1 processes (the mesh
    "pod=W": one pod a process), this rank's part of
    ``build_lm_train`` / ``build_encdec_train`` over the mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data import synthetic as D
    from repro_torch.launch import dist as LD
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import compress as C
    from repro_torch.optim import sgd
    from repro_torch.sharding import fsdp as F
    from repro_torch.train import step as ST
    from repro_torch.train import trainer as TR
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import recover_or_init

    world = LD.env_world()
    spec = args.mesh or (f"pod={world}" if world > 1 else None)
    shape = spmd.parse_mesh_spec(spec, world) if spec else {}
    if args.model_parallel != 1 and shape.get("model", 1) == 1:
        if not args.mesh:
            ST.check_mesh(Mesh({"model": args.model_parallel}))
        print("[warn] --model-parallel ignored: --mesh controls the axis "
              f"sizes (use e.g. --mesh pod,data,model={args.model_parallel})")
    ST.check_mesh(Mesh(shape))
    if spec and args.pods not in (1, shape.get("pod", 1)):
        raise SystemExit(f"--pods {args.pods} != the mesh's "
                         f"{shape.get('pod', 1)} pods")
    if args.deterministic:
        import torch

        torch.use_deterministic_algorithms(True, warn_only=True)
    import torch.distributed as dist

    pods = LD.init_from_env(args.device)
    say = _emit if pods.rank == 0 else (lambda *a, **k: None)
    try:
        mesh = (spmd.make_spmd_mesh(spec, world=pods.world, rank=pods.rank)
                if spec else None)
        arch = get_arch(args.arch)
        cfg = _cut_depth(arch, arch.smoke if args.smoke else arch.full,
                         args.layers)
        n, m = (int(v) for v in args.nm.split(":"))
        sp_cfg = SparsityConfig(n=n, m=m, method=args.method,
                                granularity=args.granularity)
        opt_cfg = sgd.SGDConfig(lr=args.lr, total_steps=args.steps)
        encdec = arch.family == "encdec"
        compress = args.compress and not encdec and (
            mesh is None or "pod" in mesh.axis_names)
        if args.compress and not compress:
            say("[warn] --compress ignored: "
                + ("the encoder-decoder trains without the compressed "
                   "sync, as the reference's does" if encdec else
                   "mesh has no 'pod' axis (use --mesh pod=2,data=...)"))
        grad_sync = C.GradCompressConfig(
            n=n, m=m, estimator=args.grad_estimator,
            bucket_elems=args.bucket_elems) if compress else None
        if mesh is None:
            where = f"pods {args.pods} on {pods.device}"
            bundle = (functools.partial(
                ST.encdec_train_step, cfg=cfg, sp_cfg=sp_cfg,
                opt_cfg=opt_cfg) if encdec else functools.partial(
                ST.lm_train_step, cfg=cfg, sp_cfg=sp_cfg, opt_cfg=opt_cfg,
                compress=compress, n_pods=args.pods, grad_sync=grad_sync))
            shardings, rows = None, None

            def fresh():
                return ST.init_train_state(cfg, sp_cfg, seed=args.seed,
                                           device=pods.device,
                                           compress=compress,
                                           n_pods=args.pods)
        else:
            where = f"mesh {dict(mesh.shape)}"
            bundle = (ST.build_encdec_train(cfg, mesh, sp_cfg, opt_cfg)
                      if encdec else ST.build_lm_train(
                          cfg, mesh, sp_cfg, opt_cfg, compress=compress,
                          grad_sync=grad_sync))
            shardings = bundle.state_shardings
            rows = (mesh.coord("pod") * mesh.shape.get("data", 1)
                    + mesh.coord("data"), mesh.shape.get("pod", 1)
                    * mesh.shape.get("data", 1))

            def fresh():
                return bundle.init_state(cfg, sp_cfg, seed=args.seed,
                                         device=pods.device,
                                         compress=compress)
        say(f"{where} | {args.arch} "
            f"({'smoke' if args.smoke else 'full'}) | {args.method} {n}:{m} "
            f"{args.granularity}"
            + (f" | compressed pod sync ({args.grad_estimator})"
               if compress else "")
            + (f" | {pods.world} processes, backend "
               f"{dist.get_backend(pods.group)} on {pods.device}"
               if pods.group is not None else ""))
        if args.resume and args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir, shardings=shardings)
            state, _ = recover_or_init(
                mgr, fresh, device=pods.device,
                restore_fn=functools.partial(
                    ST.restore_with_pregen, mgr, sp_cfg=sp_cfg,
                    shardings=shardings))
        else:
            state = fresh()
        start = int(state["step"])
        if encdec:
            stream = D.encdec_stream(cfg.vocab, args.batch, args.seq,
                                     cfg.d_model, device=pods.device,
                                     seed=args.seed, start=start, rows=rows)
        else:
            stream = D.lm_stream(cfg.vocab, args.batch, args.seq,
                                 device=pods.device, seed=args.seed,
                                 start=start,
                                 prefix=8 if arch.prefix_len else 0,
                                 d_model=cfg.d_model, rows=rows)
        tcfg = TR.TrainerConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            log_every=args.log_every, ckpt_dir=args.ckpt_dir,
            heartbeat_path=(os.path.join(args.ckpt_dir, "heartbeat.json")
                            if args.ckpt_dir else None))
        C.reset_hop_stats()
        F.reset_stats()
        state, history = TR.fit(bundle, state, stream, tcfg, log_fn=say)
        if args.digest:
            _print_digest(state, history, mesh, say)
        final = history[-1]["loss"] if history else float("nan")
        say(f"done: {len(history)} steps, final loss {final:.4f}")
        return 0
    finally:
        LD.shutdown(pods)


def _cut_depth(arch, cfg, layers):
    if layers is None:
        return cfg
    depth = ({"n_layers": layers, "n_enc_layers": layers}
             if arch.family == "encdec" else {"n_layers": layers})
    return dataclasses.replace(cfg, **depth)


def _print_digest(state, history, mesh, say):
    """``--digest``: exact losses, and each rank's state bytes, peak
    device memory, step times, kernel launches, the bytes its gathers,
    reductions and pod hop sent a step and the hop's gathers a step, and
    the fingerprint of its state (its blocks and its residual row on a
    mesh, ``checkpoint.state_fingerprint``): two runs with the same
    fingerprints on every rank hold the same bits."""
    import torch

    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import compress as C
    from repro_torch.sharding import fsdp as F
    from repro_torch.train.checkpoint import state_fingerprint

    say("losses " + repr([h["loss"] for h in history]))
    steps = max(len(history), 1)
    nbytes = sum(t.numel() * t.element_size() for t in F.tensors(state))
    dev = F.tensors(state)[0].device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    step_ms = [round(h["sec"] * 1e3, 1) for h in history]
    rank, coords = (0, {}) if mesh is None else (mesh.rank, mesh.coords)
    _emit(f"rank {rank} coords {coords} state_bytes {nbytes} "
          f"peak_bytes {peak} step_ms {step_ms} "
          f"launches nm_spmm {KS.launches} fused_update {KF.launches} "
          f"grad_compress {KG.launches['grad_compress']} "
          f"grad_decompress_mean {KG.launches['grad_decompress_mean']} "
          f"gathered_bytes_per_step {F.stats['gather_bytes'] // steps} "
          f"reduced_bytes_per_step {F.stats['reduce_bytes'] // steps} "
          f"hop_bytes_per_step {C.hop_stats['bytes_sent'] // steps} "
          f"hop_gathers_per_step {C.hop_stats['gathers'] // steps} "
          f"fingerprint {state_fingerprint(state)}")


def _emit(line: str):
    """One line to stdout in one write: the ranks of a group share the
    pipe, and a line written in pieces (unbuffered stdout writes the text
    and its newline apart) interleaves with another rank's."""
    sys.stdout.write(f"{line}\n")
    sys.stdout.flush()


def run_watchdog(args, argv) -> int:
    """Supervise: restart on a stale heartbeat until the steps are done."""
    if not args.ckpt_dir:
        raise SystemExit("--watchdog requires --ckpt-dir")
    from repro_torch.launch.dist import env_world

    if env_world() > 1:
        raise SystemExit("--watchdog supervises one process: run it "
                         "around torchrun, not under it")
    hb_path = os.path.join(args.ckpt_dir, "heartbeat.json")
    child_argv = [a for a in argv if a != "--watchdog"] + ["--resume"]
    attempts = 0
    while attempts < 10:
        attempts += 1
        proc = subprocess.Popen([sys.executable, "-m",
                                 "repro_torch.launch.train", *child_argv],
                                env=dict(os.environ))
        while proc.poll() is None:
            time.sleep(2.0)
            try:
                age = time.time() - os.path.getmtime(hb_path)
            except OSError:
                continue
            if age > args.heartbeat_timeout:
                print(f"[watchdog] heartbeat stale ({age:.0f}s): "
                      "restarting from the latest checkpoint")
                proc.kill()
                proc.wait()
                break
        if proc.returncode == 0:
            return 0
    return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if args.watchdog:
        sys.exit(run_watchdog(args, argv))
    sys.exit(run_training(args))


if __name__ == "__main__":
    main()
