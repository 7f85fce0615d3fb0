"""Helpers of the port's compressed-sync tests: ``check_pod_split_metrics``
(the compressed step, two pods on one device, takes each pod's loss and
aux on its own rows of the batch, and its loss, aux and total are their
means over the pods), ``run_references`` (``jax_sync_reference.py`` jobs
in fresh processes, side by side) and the tree comparisons."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import operand as TO

from repro_torch.data.synthetic import lm_stream
from repro_torch.models import transformer_lm as TT
from repro_torch.train import step as TST


def check_pod_split_metrics(cfg, sp, opt, batch, seq, pods=2):
    state = TST.init_train_state(cfg, sp, device="cpu", compress=True,
                                 n_pods=pods)
    _, b = next(lm_stream(cfg.vocab, batch * pods, seq, device="cpu"))
    want = []
    with torch.no_grad():
        for p in range(pods):
            rows = slice(p * batch, (p + 1) * batch)
            hidden, _, aux = TT.forward(state["compute"], b["tokens"][rows],
                                        cfg, sp)
            loss = TT.lm_loss(state["compute"], hidden, b["labels"][rows],
                              cfg)
            want.append((loss, aux, loss + TST.AUX_COEF * aux))
    width = state["err"].shape[1]
    new, metrics = TST.lm_train_step(state, b, cfg=cfg, sp_cfg=sp,
                                     opt_cfg=opt, compress=True,
                                     n_pods=pods)
    for j, key in enumerate(("loss", "aux", "total")):
        mean = torch.stack([w[j] for w in want]).mean()
        assert torch.equal(metrics[key], mean), (key, metrics[key], mean)
    assert new["err"].shape == (pods, width) and new["step"] == 1
    assert bool(torch.isfinite(new["err"]).all())
    assert float(new["err"].abs().sum()) > 0
    return metrics


ROOT = Path(__file__).resolve().parents[1]


def run_references(tmp_path_factory, jobs, pods=2):
    """{name: result} of ``tests/jax_sync_reference.py`` jobs (name:
    argument list after OUT.pkl), all started at once, each on a forced
    ``pods``-device CPU mesh."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={pods}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for name, argv in jobs.items():
        dst = tmp_path_factory.mktemp(name) / "out.pkl"
        procs[name] = (dst, subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "jax_sync_reference.py"),
             str(dst), *argv], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (dst, proc) in procs.items():
        _, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, err[-4000:]
        with open(dst, "rb") as f:
            out[name] = pickle.load(f)
    return out


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _pairs(jtree, ttree, path=""):
    """(name, reference leaf of one layer, port leaf) over both trees."""
    import jax

    if isinstance(ttree, dict):
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(ttree, list):
        for i, t in enumerate(ttree):
            yield from _pairs(jax.tree.map(lambda a, i=i: a[i], jtree), t,
                              f"{path}[{i}]")
    else:
        yield path, jtree, ttree


def assert_tree_bitwise(jtree, ttree):
    n = 0
    for name, j, t in _pairs(jtree, ttree):
        if isinstance(t, TO.PregenOp):
            for f in ("bp", "ff", "vals", "idx", "mask"):
                jf, tf = getattr(j, f), getattr(t, f)
                assert (jf is None) == (tf is None), f"{name}.{f}"
                if tf is not None:
                    assert np.array_equal(bits(jf), bits(tf)), f"{name}.{f}"
                    n += 1
        else:
            assert np.array_equal(bits(j), bits(t)), name
            n += 1
    assert n > 0


def pod_stacked(tree):
    """The reference's pod-stacked grads ((P, L, ...) under the block
    lists) as the port's per-layer tree of (P, ...) leaves."""
    def layer_first(node):
        if isinstance(node, dict):
            return {k: layer_first(v) for k, v in node.items()}
        return np.moveaxis(np.asarray(node), 1, 0)

    moved = {k: (layer_first(v) if k in convert.STACKS else v)
             for k, v in tree.items()}
    return convert.params_from_jax(moved, device="cpu")
