"""Port parity: the compressed cross-pod gradient sync.

The reference's ``optim.compress.cross_pod_sync`` runs, compiled, on a
forced CPU mesh (pod=P, data=1, model=1) of ``AxisType.Auto`` axes in a
fresh process (``XLA_FLAGS=--xla_force_host_platform_device_count=P``
must be set before JAX starts, and this process has started it with one
device): P = 2 takes its two-pod ppermute path, P = 4 its all_gather
path.  The port's ``cross_pod_sync`` on the same pod-stacked gradients
must give the same mean gradients and the same error-feedback residual
BITWISE, over 4 steps of residual carry-over, for fp32 and bf16
gradients.

The tree is master-shaped like a model's: layer-stacked block leaves in
the reference, a per-layer list in the port, keys not in sorted order,
and a ragged (3,) leaf that takes the dense pod mean.  The reference's
residual slab and the port's differ in column order (``convert``); it is
compared through ``convert.err_to_jax``.  The reference's buckets (32
elements) straddle its leaves' boundaries in the slab, the port's chunks
never do: the result is the same.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.optim import compress as C
from repro_torch.optim import sgd

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4
BUCKET = 32
LAYERS = 2
# (name, per-layer shape) of the block leaves; then the top-level leaves
BLOCK = [("w", (16, 24)), ("norm", (8,))]
TOP = [("emb", (40, 8)), ("bias", (3,))]

WORKER = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh, PartitionSpec as P
from repro.optim import compress as C

inp = dict(np.load(sys.argv[1]))
pods, bucket, steps = (int(inp.pop(k)) for k in ("pods", "bucket", "steps"))
mesh = Mesh(np.array(jax.devices()).reshape(pods, 1, 1),
            ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
out = {}
for dt in ("float32", "bfloat16"):
    def tree(step):
        g = {k.split("|")[2]: v for k, v in inp.items()
             if k.startswith(f"g|{step}|")}
        g = {k: jnp.asarray(v).astype(dt) for k, v in g.items()}
        return {"emb": g["emb"], "bias": g["bias"],
                "blocks": {"w": g["w"], "norm": g["norm"]}}
    master = jax.tree.map(lambda x: x[0], tree(0))
    specs = jax.tree.map(lambda x: P(), master)
    cfg = C.GradCompressConfig(n=2, m=8, bucket_elems=bucket)
    err = jnp.zeros((pods, C.err_state_elems(master, 8, mesh, specs)),
                    jnp.float32)
    sync = jax.jit(lambda g, e: C.cross_pod_sync(g, e, mesh, specs, cfg))
    for step in range(steps):
        mean, err = sync(tree(step), err)
        flat = {"emb": mean["emb"], "bias": mean["bias"],
                **mean["blocks"]}
        for k, v in flat.items():
            v = np.asarray(v)
            out[f"{dt}|mean|{step}|{k}"] = (v.view(np.uint16)
                                            if dt == "bfloat16" else v)
        out[f"{dt}|err|{step}"] = np.asarray(err)
np.savez(sys.argv[2], **out)
"""


def run_reference(worker: str, inputs: dict, pods: int, tmp_path: Path):
    """Run ``worker`` (argv: input .npz, output .npz) in a fresh process
    with ``pods`` forced CPU devices; returns its outputs."""
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={pods}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", worker, str(src), str(dst)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _grads(pods: int):
    """Per step, per leaf: (pods, [layers,] *shape) fp32 draws."""
    rng = np.random.default_rng(pods)
    out = {}
    for step in range(STEPS):
        for name, shape in BLOCK:
            out[f"g|{step}|{name}"] = rng.standard_normal(
                (pods, LAYERS, *shape)).astype(np.float32) * 0.5 ** step
        for name, shape in TOP:
            out[f"g|{step}|{name}"] = rng.standard_normal(
                (pods, *shape)).astype(np.float32) * 0.5 ** step
    return out


def _port_tree(g: dict, step: int, dtype):
    """The port's per-layer tree (keys in the model's order, not sorted)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    return {"blocks": [{name: t(g[f"g|{step}|{name}"][:, i])
                        for name, _ in BLOCK} for i in range(LAYERS)],
            **{name: t(g[f"g|{step}|{name}"]) for name, _ in TOP}}


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("pods", [2, 4])
def test_sync_bitwise_vs_reference(pods, tmp_path):
    g = _grads(pods)
    ref = run_reference(WORKER, {**g, "pods": pods, "bucket": BUCKET,
                                 "steps": STEPS}, pods, tmp_path)
    for dtype, dt in ((torch.float32, "float32"), (torch.bfloat16,
                                                   "bfloat16")):
        master = sgd.tree_map(lambda _, x: x[0], _port_tree(g, 0, dtype))
        err = C.init_err(master, pods, 8)
        cfg = C.GradCompressConfig(n=2, m=8, bucket_elems=BUCKET)
        for step in range(STEPS):
            mean, err = C.cross_pod_sync(_port_tree(g, step, dtype), err, cfg)
            for name, _ in BLOCK:
                for i in range(LAYERS):
                    got = mean["blocks"][i][name]
                    assert got.dtype == dtype
                    assert np.array_equal(
                        _bits(got), ref[f"{dt}|mean|{step}|{name}"][i]), (
                            dt, step, name, i)
            for name, _ in TOP:
                assert np.array_equal(_bits(mean[name]),
                                      ref[f"{dt}|mean|{step}|{name}"]), (
                                          dt, step, name)
            want = ref[f"{dt}|err|{step}"]
            assert np.array_equal(convert.err_to_jax(err, master, 8), want)
            assert torch.equal(convert.err_from_jax(want, master, 8,
                                                    device="cpu"), err)
        assert float(err.abs().sum()) > 0
