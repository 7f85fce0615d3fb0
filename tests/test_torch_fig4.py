"""Fig. 4 on the port: a short run against the reference, and the
committed reference curves.

* ``test_first_steps_match_reference``: ResNet9 at the Fig. 4 example's
  settings (width 32, batch 64, lr 0.05 with 10 warmup steps, 2:8,
  legacy dataflow) for three steps, the reference's
  ``examples/paper_loss_curves.train_resnet9`` in a subprocess with the
  XLA flags of ``tests/jax_paper_reference.py`` (so that the compiled
  reference rounds as its source reads) and the port's
  ``examples/torch_paper_loss_curves.train_resnet9`` from the
  reference's init, converted, on the same batches.  lr is 0 at step
  0, so steps 0 and 1 see the same weights in both: their losses are
  held within 5e-3, the bound ``test_torch_dataflow.py`` holds a legacy
  ResNet9 step to from the reference's state (the convs sum the same
  bf16 products in other orders, and one bf16 flip in a BatchNorm net
  travels; measured here 2.3e-3 at step 0, 1.9e-4 at step 1).  Step 2 follows one update at lr 0.005 from gradients that agree to
  about 1% of a leaf's largest entry (``test_torch_dataflow.py``) and is
  held within 5e-2; these BatchNorm nets part further from there on
  (ROADMAP queue 3), so longer runs are held by their statistics
  (``examples/torch_paper_loss_curves.py``, ``chip_smoke.py``).
* ``test_reference_curves_schema``: ``results/fig4_reference_curves.json``
  holds every curve the tool writes, finite, with its tail means, the
  jax version and the flags.
* the band, the learning check and the ordering check of the example
  on the committed numbers: the reference's own runs pass, and runs
  that do not learn (flat at chance, or frozen at their first loss) are
  rejected.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.models import convnets as JC
from repro_torch import convert

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import torch_paper_loss_curves as E  # noqa: E402

FLAGS = "--xla_allow_excess_precision=false --xla_cpu_max_isa=AVX"
STEPS = 3
LOSS_ATOL = (5e-3, 5e-3, 5e-2)
REF_JSON = ROOT / "results" / "fig4_reference_curves.json"


def _reference_losses(method: str, steps: int) -> list:
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "fig4_reference_curves.py"),
         "--worker", "example", method, "0", str(steps)],
        env=env, capture_output=True, text=True, check=False, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("method", ["bdwp", "sdgp"])
def test_first_steps_match_reference(method):
    ref = _reference_losses(method, STEPS)
    params = JC.resnet9_init(jax.random.PRNGKey(0), num_classes=10,
                             width=E.WIDTH)
    port = E.train_resnet9(method, steps=STEPS, seed=0, device="cpu",
                           params=convert.params_from_jax(
                               jax.tree.map(np.asarray, params),
                               device="cpu"))
    assert all(math.isfinite(x) for x in port)
    diff = np.abs(np.asarray(port) - np.asarray(ref))
    assert np.all(diff <= np.asarray(LOSS_ATOL)), (port, ref)


def test_reference_curves_schema():
    doc = json.loads(REF_JSON.read_text())
    assert doc["script"] == "tools/fig4_reference_curves.py"
    assert doc["xla_flags"] == FLAGS and doc["jax_version"]
    assert doc["settings"]["width"] == E.WIDTH
    assert doc["settings"]["batch"] == E.BATCH
    assert doc["settings"]["lr"] == E.EXAMPLE_LR["lr"]
    assert doc["settings"]["warmup_steps"] == E.EXAMPLE_LR["warmup_steps"]
    assert doc["table1_lr"]["settings"]["lr"] == E.TABLE1_LR["lr"]
    assert sorted(doc["curves"]) == sorted(E.METHODS)
    for method in E.METHODS:
        runs = doc["curves"][method]
        assert sorted(runs) == [str(s) for s in doc["seeds"]]
        for seed, curve in runs.items():
            assert len(curve) == doc["steps"]
            assert all(math.isfinite(x) for x in curve)
            assert doc["tail_means"][method][seed] == pytest.approx(
                E.tail_mean(curve, doc["tail"]), rel=1e-12)
        t1 = doc["table1_lr"]["curves"][method]
        assert "0" in t1
        for curve in t1.values():
            assert len(curve) == doc["steps"]
            assert all(math.isfinite(x) for x in curve)


def test_band_and_ordering_on_the_reference():
    """The reference's own seed-mean tail lies in its band of +- 3
    sigma_d; its curves, checked as the port's are, pass; the pooled
    sigma is the root mean of the methods' seed variances."""
    doc = json.loads(REF_JSON.read_text())
    n = len(doc["seeds"])
    for method in E.METHODS:
        mean, lo, hi = E.band(doc, method, n)
        assert lo <= mean <= hi
        assert hi - lo == pytest.approx(6 * E.sigma_diff(doc, n))
    var = [np.var(list(v.values()), ddof=1)
           for v in doc["tail_means"].values()]
    assert E.pooled_sigma(doc) == pytest.approx(math.sqrt(np.mean(var)))
    assert E.check_curves(doc["curves"], doc, log=lambda *_: None)


def test_learning_threshold_between_chance_and_reference():
    """Every reference run learns, its settled loss below the threshold,
    and the threshold lies below chance."""
    doc = json.loads(REF_JSON.read_text())
    worst = max(E.settled(c) for v in doc["curves"].values()
                for c in v.values())
    assert worst < E.CHANCE - E.LEARN_MARGIN < E.CHANCE
    assert all(E.learns(c) for v in doc["curves"].values()
               for c in v.values())


@pytest.mark.parametrize("seeds", [None, (0, 1)])
@pytest.mark.parametrize("kind", ["chance", "frozen"])
def test_check_rejects_runs_that_do_not_learn(kind, seeds):
    """A port stuck at chance, or whose weights never move, fails the
    check, over the reference's seeds and over the two of chip_smoke's
    lr-0 control; the reference's chance-level curves lie inside the
    tail band, so the learning check is what rejects them."""
    doc = json.loads(REF_JSON.read_text())
    curves = E.control_curves(doc, kind, seeds)
    if kind == "chance":
        for method in E.METHODS:
            _, lo, hi = E.band(doc, method, len(curves[method]))
            assert lo <= E.CHANCE <= hi
    assert not E.check_curves(curves, doc, log=lambda *_: None)
    assert all(not E.learns(c) for v in curves.values() for c in v.values())
    assert E.controls_rejected(doc, seeds or doc["seeds"],
                               log=lambda *_: None)
