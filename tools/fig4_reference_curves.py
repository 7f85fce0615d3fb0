"""The JAX reference's Fig. 4 loss curves, for the port to be held to.

    PYTHONPATH=src python tools/fig4_reference_curves.py \
        [--out results/fig4_reference_curves.json] [--jobs 4] [--steps 120] \
        [--seeds 0 1 2 ...] [--resume]

Runs ``train_resnet9`` of ``examples/paper_loss_curves.py`` (ResNet9 at
width 32, batch 64, lr 0.05, 10 warmup steps, 2:8, synthetic blobs, the
legacy ``pregen=False`` dataflow) under the five methods and ``SEEDS``
(eight: the tail means are bimodal, a run that dies in the early loss
spike sits near chance and one that survives learns, so three seeds a
method say little of their spread), and ResNet9 at Table I's lr (0.5,
100 warmup steps; the example's width, batch and step count) under the
five methods at the same seeds.  Each
run is a subprocess on the CPU with ``XLA_FLAGS`` set to ``FLAGS``, so
the compiled reference rounds as its source reads (no excess bf16
precision, no FMA contraction: ``tests/jax_paper_reference.py``).

With ``--resume`` the curves already in ``--out`` are kept and only
the missing runs are made ("seconds" then counts those alone).  Writes
every curve, the tail-20 mean of each, the jax version and the flags to
one JSON file (``results/fig4_reference_curves.json``, which is
committed; the port's ``examples/torch_paper_loss_curves.py``,
``tests/test_torch_fig4.py`` and ``chip_smoke.py`` read it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = "--xla_allow_excess_precision=false --xla_cpu_max_isa=AVX"
METHODS = ("dense", "srste", "sdgp", "sdwp", "bdwp")
SEEDS = tuple(range(8))
EXAMPLE = {"width": 32, "batch": 64, "lr": 0.05, "warmup_steps": 10,
           "weight_decay": 5e-4, "nm": [2, 8], "image": 32,
           "num_classes": 10}
TABLE1_LR = {"lr": 0.5, "warmup_steps": 100}
TAIL = 20


def _worker(method: str, seed: int, steps: int, table1: bool) -> list:
    """One curve in this process (XLA_FLAGS already set by the parent)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import paper_loss_curves as PLC
    from repro.optim import sgd

    if not table1:
        return PLC.train_resnet9(method, tuple(EXAMPLE["nm"]), steps=steps,
                                 batch=EXAMPLE["batch"], seed=seed)

    # The example fixes lr 0.05 and 10 warmup steps; at Table I's lr its
    # own loop runs with only those two values replaced.
    class _Table1SGD:
        def __getattr__(self, name):
            return getattr(sgd, name)

        @staticmethod
        def SGDConfig(**kw):
            return sgd.SGDConfig(**{**kw, **TABLE1_LR})

    PLC.sgd = _Table1SGD()
    return PLC.train_resnet9(method, tuple(EXAMPLE["nm"]), steps=steps,
                             batch=EXAMPLE["batch"], seed=seed)


def _run(job, steps: int):
    kind, method, seed = job
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", kind, method,
         str(seed), str(steps)], env=env, capture_output=True, text=True,
        check=False)
    if out.returncode:
        raise RuntimeError(f"{job} failed:\n{out.stderr[-4000:]}")
    losses = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"{kind:8s} {method:6s} seed {seed}: tail{TAIL} "
          f"{tail_mean(losses):.4f} ({time.time() - t0:.0f} s)", flush=True)
    return job, losses


def tail_mean(xs, k: int = TAIL) -> float:
    return sum(xs[-k:]) / min(k, len(xs))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "results", "fig4_reference_curves.json"))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--resume", action="store_true",
                    help="keep the curves already in --out")
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("KIND", "METHOD", "SEED", "STEPS"))
    args = ap.parse_args()
    if args.worker:
        kind, method, seed, steps = args.worker
        losses = _worker(method, int(seed), int(steps), kind == "table1")
        print(json.dumps([float(x) for x in losses]))
        return

    seeds = args.seeds
    jobs = [("example", m, s) for m in METHODS for s in seeds]
    jobs += [("table1", m, s) for m in METHODS for s in seeds]
    results = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as fh:
            old = json.load(fh)
        if old["steps"] == args.steps:
            for m, runs in old["curves"].items():
                for s, c in runs.items():
                    results[("example", m, int(s))] = c
            for m, runs in old["table1_lr"]["curves"].items():
                for s, c in runs.items():
                    results[("table1", m, int(s))] = c
    t0 = time.time()
    todo = [j for j in jobs if j not in results]
    with ThreadPoolExecutor(args.jobs) as ex:
        results.update(ex.map(lambda j: _run(j, args.steps), todo))
    import jax

    curves = {m: {str(s): results[("example", m, s)] for s in seeds}
              for m in METHODS}
    table1 = {m: {str(s): results[("table1", m, s)] for s in seeds}
              for m in METHODS}
    doc = {
        "what": "ResNet9 loss curves of the JAX reference "
                "(examples/paper_loss_curves.py train_resnet9), legacy "
                "dataflow, on the CPU",
        "script": "tools/fig4_reference_curves.py",
        "jax_version": jax.__version__,
        "xla_flags": FLAGS,
        "steps": args.steps,
        "tail": TAIL,
        "settings": EXAMPLE,
        "seeds": list(seeds),
        "curves": curves,
        "tail_means": {m: {s: tail_mean(c) for s, c in v.items()}
                       for m, v in curves.items()},
        "table1_lr": {"settings": {**EXAMPLE, **TABLE1_LR},
                      "curves": table1},
        "seconds": round(time.time() - t0, 1),
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out} ({doc['seconds']} s)")


if __name__ == "__main__":
    main()
