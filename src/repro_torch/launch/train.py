"""Training launcher CLI of the port.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --steps 50 --method bdwp --nm 2:8 \\
      --ckpt-dir /tmp/run1 [--resume] [--watchdog] [--device cpu]

  # two pods, one process each (gloo on one card or on the CPU)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --steps 8 --compress --device cpu

Counterpart of ``src/repro/launch/train.py``: config -> train state
(fresh, or the newest checkpoint with ``--resume``) -> synthetic data
stream -> ``train.trainer.fit`` (checkpoints, heartbeat, straggler
monitor), with the same flags where they mean the same thing.
``--smoke`` (the default) takes the reduced config, ``--full`` the
published one.  ``--watchdog`` restarts ``-m repro_torch.launch.train``
with ``--resume`` whenever the heartbeat goes stale (``run_watchdog``).

What differs: the port cannot shard, so there is no ``--mesh`` and no
``--model-parallel``.  The pods of ``--compress`` come from the process
group when ``torchrun`` started W > 1 processes (one pod a process,
``launch.dist``), else from ``--pods P`` (all P pods in one tensor on
one device).  It runs on the card unless ``--device cpu`` is given, and
never falls back to the CPU on its own.  The encoder-decoder trains
without compression, as the reference's ``build_encdec_train`` does.
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
    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data import synthetic as D
    from repro_torch.launch import dist as LD
    from repro_torch.optim import compress as C
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST
    from repro_torch.train import trainer as TR
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import recover_or_init

    if args.deterministic:
        import torch

        torch.use_deterministic_algorithms(True, warn_only=True)
    pods = LD.init_from_env(args.device)
    say = _emit if pods.rank == 0 else (lambda *a, **k: None)
    try:
        arch = get_arch(args.arch)
        cfg = arch.smoke if args.smoke else arch.full
        if args.layers is not None:
            depth = ({"n_layers": args.layers, "n_enc_layers": args.layers}
                     if arch.family == "encdec"
                     else {"n_layers": args.layers})
            cfg = dataclasses.replace(cfg, **depth)
        n, m = (int(v) for v in args.nm.split(":"))
        sp_cfg = SparsityConfig(n=n, m=m, method=args.method,
                                granularity=args.granularity)
        opt_cfg = sgd.SGDConfig(lr=args.lr, total_steps=args.steps)
        encdec = arch.family == "encdec"
        if pods.group is not None and args.pods not in (1, pods.world):
            raise SystemExit(f"--pods {args.pods} != the process group's "
                             f"{pods.world} ranks")
        n_pods = pods.world if pods.group is not None else args.pods
        compress = args.compress and not encdec
        if args.compress and encdec:
            say("[warn] --compress ignored: the encoder-decoder trains "
                "without the compressed sync, as the reference's does")
        if pods.group is not None and not compress:
            raise SystemExit(f"{pods.world} processes need --compress: a "
                             "process is a pod of the compressed sync")
        hop = ""
        if compress and pods.group is not None:
            import torch.distributed as dist

            hop = (f" | {pods.world} processes, backend "
                   f"{dist.get_backend(pods.group)}")
        say(f"pods {n_pods} on {pods.device} | {args.arch} "
            f"({'smoke' if args.smoke else 'full'}) | {args.method} {n}:{m} "
            f"{args.granularity}"
            + (f" | compressed pod sync ({args.grad_estimator})"
               if compress else "") + hop)

        def fresh():
            return ST.init_train_state(
                cfg, sp_cfg, seed=args.seed, device=pods.device,
                compress=compress,
                n_pods=1 if pods.group is not None else n_pods)

        if args.resume and args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir, group=pods.group)
            state, _ = recover_or_init(mgr, fresh, device=pods.device)
        else:
            state = fresh()
        start = int(state["step"])
        if encdec:
            stream = D.encdec_stream(cfg.vocab, args.batch, args.seq,
                                     cfg.d_model, device=pods.device,
                                     seed=args.seed, start=start)
            step_fn = functools.partial(ST.encdec_train_step, cfg=cfg,
                                        sp_cfg=sp_cfg, opt_cfg=opt_cfg)
        else:
            stream = D.lm_stream(cfg.vocab, args.batch, args.seq,
                                 device=pods.device, seed=args.seed,
                                 start=start,
                                 prefix=8 if arch.prefix_len else 0,
                                 d_model=cfg.d_model)
            grad_sync = C.GradCompressConfig(
                n=n, m=m, estimator=args.grad_estimator,
                bucket_elems=args.bucket_elems) if compress else None
            step_fn = functools.partial(
                ST.lm_train_step, cfg=cfg, sp_cfg=sp_cfg, opt_cfg=opt_cfg,
                compress=compress, n_pods=n_pods, grad_sync=grad_sync,
                group=pods.group)
        tcfg = TR.TrainerConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            log_every=args.log_every, ckpt_dir=args.ckpt_dir,
            heartbeat_path=(os.path.join(args.ckpt_dir, "heartbeat.json")
                            if args.ckpt_dir else None))
        C.reset_hop_stats()
        state, history = TR.fit(step_fn, state, stream, tcfg, log_fn=say,
                                group=pods.group)
        if args.digest:
            _print_digest(state, history, pods, args, say)
        final = history[-1]["loss"] if history else float("nan")
        say(f"done: {len(history)} steps, final loss {final:.4f}")
        return 0
    finally:
        LD.shutdown(pods)


def _emit(line: str):
    """One line to stdout in one write: the ranks of a group share the
    pipe, and a line written in pieces (unbuffered stdout writes the text
    and its newline apart) interleaves with another rank's."""
    sys.stdout.write(f"{line}\n")
    sys.stdout.flush()


def _print_digest(state, history, pods, args, say):
    """The lines ``--digest`` prints: exact losses and the final shared
    state's fingerprint (``checkpoint.state_fingerprint``) from rank 0,
    each residual row's fingerprint and each rank's kernel launches, and
    the hop's bytes a step against ``wire_bytes``."""
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import compress as C
    from repro_torch.optim import sgd
    from repro_torch.train.checkpoint import state_fingerprint

    say("losses " + repr([h["loss"] for h in history]))
    say("fingerprint shared " + state_fingerprint(
        {k: v for k, v in state.items() if k != "err"}))
    if "err" in state:   # one row a rank, or every pod's row here
        rows = state["err"].shape[0]
        for r in range(rows):
            _emit(f"fingerprint err rank {pods.rank + r} "
                  f"{state_fingerprint(state['err'][r:r + 1])}")
    _emit(f"launches rank {pods.rank} nm_spmm {KS.launches} fused_update "
          f"{KF.launches} grad_compress {KG.launches['grad_compress']} "
          f"grad_decompress_mean {KG.launches['grad_decompress_mean']}")
    if pods.group is not None and history:
        plan = C.plan_for(state["master"], args.bucket_elems,
                          int(args.nm.split(":")[1]))
        n = int(args.nm.split(":")[0])
        total = sum(numel for _, _, numel in plan.units)
        ragged = sum(x.numel() for x, off in zip(
            sgd.tree_leaves(state["master"]), plan.offsets) if off is None)
        want = C.wire_bytes(total, ragged, C.GradCompressConfig(
            n=n, m=plan.m, bucket_elems=args.bucket_elems))
        steps = len(history)
        say(f"hop backend {C.hop_stats['backend']} gathers a step "
            f"{C.hop_stats['gathers'] / steps:.0f} bytes sent a step "
            f"{C.hop_stats['bytes_sent'] / steps:.0f} wire_bytes {want} "
            f"payload on {pods.device}")


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
