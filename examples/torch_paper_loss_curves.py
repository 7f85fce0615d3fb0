"""Fig. 4 on the port: ResNet9 loss curves under dense / SR-STE / SDGP /
SDWP / BDWP at 2:8, held to the JAX reference's committed curves.

  PYTHONPATH=src python examples/torch_paper_loss_curves.py \
      [--device cpu] [--steps 120] [--seeds 0 1 2] [--table1]

The port's counterpart of ``examples/paper_loss_curves.py``: ResNet9 at
width 32, batch 64, lr 0.05 with 10 warmup steps, weight decay 5e-4,
synthetic class blobs, on the legacy dataflow (``pregen=False``: every
conv and the classifier re-derive their masks from the fp32 master),
through ``train.step.image_train_step``, from the port's own seeded
init and ``data.synthetic.image_batch`` (the reference's batches bit
for bit).  Runs on the card unless ``--device`` names another.

Small BatchNorm nets part within two steps (ROADMAP queue 3; here a
1e-6 relative nudge of the initial weights moves the port's own
gradients by 16% (dense) to 27% (SDGP) of a leaf's norm), so the port is
held to the reference's statistics, not its bits
(``results/fig4_reference_curves.json``, written by
``tools/fig4_reference_curves.py``).  Two checks a method must pass:

* learning: at least ``MIN_LEARNED`` of its runs learn, a run's settled
  loss (the median of its losses from step ``SETTLE_FROM`` on, past the
  warmup's loss spike, so that one late spike does not move it) below
  chance, ln 10, by ``LEARN_MARGIN`` (2.20 nats: between chance and the
  highest settled loss of the reference's 40 runs, 2.12; all 40 learn).
  A port that does not learn (lr 0, or a flat chance-level loss) fails
  it: ``control_curves`` makes such runs and the checks must reject
  them;
* location: its tail-20 mean, averaged over the seeds, in the band of
  the reference's seeds: their mean +- 3 sigma_d, sigma_d the standard
  deviation of a difference of two means of that many seeds each, from
  the seed-to-seed variance pooled over the five methods (the runs are
  bimodal: one that dies in the early loss spike sits near chance, one
  that survives learns; the methods share that noise).  The band is
  wide (+- 1.02 nats at eight seeds) and holds chance: it catches a
  port that diverges or settles far from the reference, not one that
  learns a little better or worse.

The ordering check (does SDGP end at or above BDWP?) must read as the
reference's does where the reference resolves it, its gap above 2
sigma_d; otherwise it is printed as unresolved.  ``--table1``
also runs each method at Table I's lr (0.5, 100 warmup steps) at the
same seeds and reports whether the loss keeps rising, beside the
reference's curves.  Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import paper_models as PM  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig  # noqa: E402
from repro_torch.data import synthetic as D  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import step as ST  # noqa: E402

METHODS = ("dense", "srste", "sdgp", "sdwp", "bdwp")
REFERENCE = os.path.join(ROOT, "results", "fig4_reference_curves.json")
WIDTH, BATCH, TAIL = 32, 64, 20
EXAMPLE_LR = {"lr": 0.05, "warmup_steps": 10}
TABLE1_LR = {"lr": 0.5, "warmup_steps": 100}
CHANCE = math.log(10)
# A run learns when its settled loss is below CHANCE - LEARN_MARGIN; a
# method passes when at least MIN_LEARNED of its runs learn.
SETTLE_FROM, LEARN_MARGIN, MIN_LEARNED = 20, 0.1, 0.5


def train_resnet9(method: str, *, steps: int = 120, seed: int = 0,
                  device=None, lr: dict = EXAMPLE_LR, params=None,
                  nm=(2, 8)) -> list:
    """The loss of every step of one run, as floats (read once, at the
    end).  ``params``: start from these fp32 params (for example the
    reference's, converted) instead of the port's init from ``seed``."""
    model = PM.image_model("resnet9", width=WIDTH)
    sp = SparsityConfig(n=nm[0], m=nm[1], method=method)
    opt = sgd.SGDConfig(total_steps=steps, weight_decay=5e-4, **lr)
    if params is None:
        state = ST.init_image_train_state(model, sp, seed=seed,
                                          device=device, pregen=False)
    else:
        state = ST.train_state_from_params(params, sp, pregen=False)
    device = sgd.tree_leaves(state["master"])[0].device
    icfg = D.ImageTaskConfig(image=32, num_classes=model.num_classes,
                             batch=BATCH, seed=seed)
    losses = []
    for step in range(steps):
        images, labels = D.image_batch(icfg, step, device=device)
        state, met = ST.image_train_step(
            state, {"images": images, "labels": labels}, model=model,
            sp_cfg=sp, opt_cfg=opt, pregen=False)
        losses.append(met["loss"])
    return [float(x) for x in torch.stack(losses).cpu()]


def tail_mean(xs, k: int = TAIL) -> float:
    return sum(xs[-k:]) / min(k, len(xs))


def settled(losses) -> float:
    """The loss a run settles at: the median from step SETTLE_FROM on."""
    return statistics.median(losses[SETTLE_FROM:])


def learns(losses) -> bool:
    return settled(losses) < CHANCE - LEARN_MARGIN


def load_reference(path: str = REFERENCE) -> dict:
    with open(path) as fh:
        return json.load(fh)


def pooled_sigma(ref: dict) -> float:
    """The seed-to-seed standard deviation of a tail mean, pooled over
    the methods of the reference."""
    return math.sqrt(statistics.fmean(
        statistics.variance(v.values()) for v in ref["tail_means"].values()))


def sigma_diff(ref: dict, n_port: int) -> float:
    """Standard deviation of (a mean of ``n_port`` seeds) - (the
    reference's mean of its seeds) under the pooled seed noise."""
    return pooled_sigma(ref) * math.sqrt(1 / len(ref["seeds"]) + 1 / n_port)


def band(ref: dict, method: str, n_port: int):
    """(mean, lo, hi): the reference's mean tail of ``method`` and the
    band a mean of ``n_port`` seeds must lie in."""
    mean = statistics.fmean(ref["tail_means"][method].values())
    half = 3 * sigma_diff(ref, n_port)
    return mean, mean - half, mean + half


def ordering(tails: dict):
    """The reference example's check: (BDWP - dense, SDGP - dense, does
    SDGP end at or above BDWP)."""
    return (tails["bdwp"] - tails["dense"], tails["sdgp"] - tails["dense"],
            tails["sdgp"] >= tails["bdwp"])


def check_curves(curves: dict, ref: dict, log=print) -> bool:
    """Print and hold the port's runs ({method: {seed: losses}}) to the
    reference's: each method's share of runs that learn, its tail mean
    in the band and, where the reference resolves it, the ordering."""
    ok, port_tails = True, {}
    for method, runs in curves.items():
        tails = [tail_mean(c) for c in runs.values()]
        port_tails[method] = statistics.fmean(tails)
        mean, lo, hi = band(ref, method, len(tails))
        inside = lo <= port_tails[method] <= hi
        n_learn = sum(learns(c) for c in runs.values())
        enough = n_learn >= MIN_LEARNED * len(runs)
        ref_runs = ref["curves"][method].values()
        ok &= inside and enough and all(math.isfinite(t) for t in tails)
        log(f"  {method:6s} tail{TAIL} per seed "
            + " ".join(f"{t:.4f}" for t in tails)
            + f", mean {port_tails[method]:.4f}; reference {mean:.4f} band "
            f"[{lo:.4f}, {hi:.4f}] {'inside' if inside else 'OUTSIDE'}; "
            f"learned {n_learn}/{len(runs)} "
            f"({'enough' if enough else 'TOO FEW'}; reference "
            f"{sum(learns(c) for c in ref_runs)}/{len(ref_runs)}), settled "
            f"mean {statistics.fmean(settled(c) for c in runs.values()):.4f}"
            f" (reference "
            f"{statistics.fmean(settled(c) for c in ref_runs):.4f})")
    if set(port_tails) == set(METHODS):
        n = len(next(iter(curves.values())))
        ref_tails = {m: band(ref, m, n)[0] for m in METHODS}
        mine, theirs = ordering(port_tails), ordering(ref_tails)
        sd = pooled_sigma(ref) * math.sqrt(2 / len(ref["seeds"]))
        resolved = abs(ref_tails["sdgp"] - ref_tails["bdwp"]) > 2 * sd
        log(f"  ordering (Fig. 4): BDWP-dense {mine[0]:+.4f}, SDGP-dense "
            f"{mine[1]:+.4f}, SDGP >= BDWP {mine[2]}; reference "
            f"{theirs[0]:+.4f}, {theirs[1]:+.4f}, {theirs[2]} ("
            + ("resolved" if resolved else "not resolved")
            + f": its SDGP-BDWP gap {ref_tails['sdgp'] - ref_tails['bdwp']:+.4f}"
            f" against 2 sigma {2 * sd:.4f}; pooled seed sigma "
            f"{pooled_sigma(ref):.4f})")
        if resolved:
            ok &= mine[2] == theirs[2]
    return ok


def control_curves(ref: dict, kind: str, seeds=None) -> dict:
    """Runs of a port that does not learn, to show that ``check_curves``
    rejects them: "chance", every step's loss ln 10 (a port stuck at a
    uniform prediction); "frozen", each reference run's step-0 loss at
    every step (a port whose weights never move)."""
    out = {}
    for method in METHODS:
        runs = ref["curves"][method]
        keys = [str(s) for s in seeds] if seeds is not None else list(runs)
        out[method] = {k: [CHANCE if kind == "chance" else runs[k][0]]
                       * ref["steps"] for k in keys}
    return out


def controls_rejected(ref: dict, seeds, log=print, extra=None) -> bool:
    """Do the checks reject every control (``control_curves``' kinds
    over ``seeds``, and ``extra``: {name: curves} of real runs that must
    not learn)?"""
    ok = True
    runs = {kind: control_curves(ref, kind, seeds)
            for kind in ("chance", "frozen")}
    for name, curves in {**runs, **(extra or {})}.items():
        rejected = not check_curves(curves, ref, log=lambda *_: None)
        log(f"  control {name}: "
            + ("rejected" if rejected else "ACCEPTED (the check is blind)"))
        ok &= rejected
    return ok


def rises(losses, k: int = TAIL) -> bool:
    """Does the loss keep rising: is the tail mean above the first
    step's loss?"""
    return tail_mean(losses, k) > losses[0]


def report_table1(curves: dict, ref: dict, log=print) -> None:
    """Print the port's Table I lr runs ({method: {seed: losses}}) beside
    the reference's runs of the same seeds, and per method how many of
    each package's runs keep rising."""
    for method, runs in curves.items():
        refs = ref["table1_lr"]["curves"][method]
        for seed, losses in runs.items():
            pairs = [("port", losses)]
            if seed in refs:
                pairs.append(("ref", refs[seed]))
            for who, c in pairs:
                marks = (0, 4, 10, 20, 60, len(c) - 1)
                log(f"  {method:6s} {who:4s} seed {seed}: " + " ".join(
                    f"s{i}={c[i]:.2f}" for i in marks) + f", peak "
                    f"{max(c):.2f}, tail{TAIL} {tail_mean(c):.4f}, keeps "
                    f"rising: {rises(c)}")
        log(f"  {method:6s} keep rising: port {sum(map(rises, runs.values()))}"
            f"/{len(runs)}, reference {sum(map(rises, refs.values()))}/"
            f"{len(refs)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="default: the reference's seeds")
    ap.add_argument("--table1", action="store_true",
                    help="also run Table I's lr (0.5, 100 warmup steps)")
    ap.add_argument("--out", help="write every curve here (JSON)")
    args = ap.parse_args(argv)
    ref = load_reference()
    args.seeds = args.seeds or ref["seeds"]
    print(f"ResNet9(w={WIDTH}) on synthetic blobs, 2:8, batch {BATCH}, "
          f"{args.steps} steps, seeds {args.seeds}, legacy dataflow")
    t0 = time.perf_counter()
    curves = {m: {str(s): train_resnet9(m, steps=args.steps, seed=s,
                                        device=args.device)
                  for s in args.seeds} for m in METHODS}
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    ok = check_curves(curves, ref)
    ok &= controls_rejected(ref, args.seeds)
    out = {"curves": curves}
    if args.table1:
        print(f"Table I's lr {TABLE1_LR['lr']}, {TABLE1_LR['warmup_steps']} "
              f"warmup steps, seeds {args.seeds}:")
        t1 = {m: {str(s): train_resnet9(m, steps=args.steps, seed=s,
                                        device=args.device, lr=TABLE1_LR)
                  for s in args.seeds} for m in METHODS}
        report_table1(t1, ref)
        out["table1_lr"] = t1
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    print("fig4 OK" if ok else "fig4 FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
