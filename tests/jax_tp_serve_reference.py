"""The reference's serving over a forced 4-device CPU mesh (pod, data,
model) of ``AxisType.Auto`` axes, for the port's sharded serving tests.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      python tests/jax_tp_serve_reference.py OUT.pkl CASE...

  CASE  ARCH:P,D,M:packed|masked[:SLOTS]   the continuous-batching engine
        serve:ARCH:P,D,M:packed|masked     build_lm_serve

The engine runs the workload of the reference's own sharded-vs-solo
test (``tests/test_spmd.py``'s ``TestServeParity``): SMOKE weights from
``PRNGKey(0)`` in bf16, 2:8 bdwp, ``ServeConfig(n_slots=SLOTS (4),
max_len=32, prompt_bucket=12)``, prompts of (4, 7, 11, 5, 9) tokens
from ``default_rng(3)``, 8 new tokens each; packed is u4.  Each case
runs over its mesh (the first P x D x M devices), and each (arch,
packing, slots) once solo.

``build_lm_serve`` (``packed``: from ``bdwp.pack_tree_shared`` weights)
runs a prefill of SERVE_ROWS x SERVE_PROMPT tokens and SERVE_STEPS
shared-cursor decode steps whose tokens are forced (``default_rng(5)``:
the prompt rows, then the decode tokens), the prefill's cache seated in
a cache SERVE_STEPS deeper as ``tests/test_archs.py`` seats it; the
bundle over the case's mesh ("sharded") and over one device ("one"),
each its logits at every step (fp32), or the error it raised.

Writes each arch's weights (numpy trees, pickled; {arch: params}) to
OUT.pkl.params as soon as it has them, then {case: result} to OUT.pkl:
an engine case (arch, (P, D, M), packed, slots) gives {"solo":
streams, "sharded": streams}, a serve case ("serve", arch, (P, D, M),
packed) gives {"tokens", "forced", "sharded", "one"}.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, Mesh

from repro.configs import get_arch
from repro.core import bdwp as B
from repro.core.sparsity import SparsityConfig
from repro.models import transformer_lm as T
from repro.serve import ServeConfig, ServeEngine
from repro.train import step as ST

LENGTHS = (4, 7, 11, 5, 9)
NEW = 8
SP = SparsityConfig(n=2, m=8, method="bdwp")
SERVE_ROWS, SERVE_PROMPT, SERVE_STEPS = 4, 12, 4


def streams(params, cfg, packed, mesh, slots):
    sc = ServeConfig(n_slots=slots, max_len=32, prompt_bucket=12,
                     packed=packed)
    eng = ServeEngine(params, cfg, SP, sc, mesh=mesh)
    rng = np.random.default_rng(3)
    for length in LENGTHS:
        eng.submit(rng.integers(0, cfg.vocab, length).tolist(),
                   max_new_tokens=NEW)
    return eng.run()


def serve_inputs(cfg):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (SERVE_ROWS, SERVE_PROMPT))
    forced = rng.integers(0, cfg.vocab, (SERVE_STEPS, SERVE_ROWS))
    return tokens, forced


def lm_serve(params, cfg, packed, mesh, tokens, forced):
    """build_lm_serve's prefill, then SERVE_STEPS forced decode steps:
    the logits of each (fp32 numpy)."""
    i32 = jnp.int32
    tree = B.pack_tree_shared(params, SP) if packed else params
    b, s = tokens.shape
    pre = ST.build_lm_serve(
        cfg, mesh, SP, {"tokens": jax.ShapeDtypeStruct((b, s), i32)},
        prefill=True, packed=packed)
    logits, cache = pre.step_fn(tree, {"tokens": jnp.asarray(tokens, i32)})
    full = T.init_lm_cache(cfg, b, s + SERVE_STEPS)

    def seat(dst, src):
        if dst.ndim == 0 or dst.shape == src.shape:
            return src.astype(dst.dtype)
        sl = tuple(slice(0, d) for d in src.shape)
        return dst.at[sl].set(src.astype(dst.dtype))

    cache = jax.tree.map(seat, full, cache)
    dec = ST.build_lm_serve(
        cfg, mesh, SP, {"cache": jax.eval_shape(lambda: full),
                        "token": jax.ShapeDtypeStruct((b, 1), i32),
                        "pos": jax.ShapeDtypeStruct((), i32)},
        packed=packed)
    out = [np.asarray(logits, np.float32)]
    for i in range(SERVE_STEPS):
        logits, cache = dec.step_fn(tree, cache,
                                    jnp.asarray(forced[i][:, None], i32),
                                    jnp.asarray(s + i, i32))
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)


def parse(case):
    parts = case.split(":")
    serve = parts[0] == "serve"
    if serve:
        parts = parts[1:]
    arch, shape, packing = parts[:3]
    shape = tuple(int(x) for x in shape.split(","))
    if serve:
        return ("serve", arch, shape, packing == "packed")
    return (arch, shape, packing == "packed",
            int(parts[3]) if len(parts) > 3 else 4)


def main(dst, *cases):
    cases = [parse(c) for c in cases]
    weights = {}
    for case in cases:
        arch = case[1] if case[0] == "serve" else case[0]
        if arch not in weights:
            params, _ = T.init(jax.random.PRNGKey(0), get_arch(arch).smoke)
            weights[arch] = jax.tree.map(lambda w: w.astype(jnp.bfloat16),
                                         params)
    with open(dst + ".params.tmp", "wb") as f:   # the port starts from them
        pickle.dump(jax.tree.map(np.asarray, weights), f)
    os.replace(dst + ".params.tmp", dst + ".params")
    out, solo = {}, {}
    for case in cases:
        if case[0] == "serve":
            _, arch, shape, packed = case
            cfg, params = get_arch(arch).smoke, weights[arch]
            tokens, forced = serve_inputs(cfg)
            res = {"tokens": tokens, "forced": forced}
            for key, mesh in (("sharded", shape), ("one", (1, 1, 1))):
                try:
                    res[key] = lm_serve(params, cfg, packed, mesh_of(mesh),
                                        tokens, forced)
                except Exception as e:   # reported by the test
                    res[key] = f"{type(e).__name__}: {e}"
            out[case] = res
            continue
        arch, shape, packed, slots = case
        cfg, params = get_arch(arch).smoke, weights[arch]
        if (arch, packed, slots) not in solo:
            solo[arch, packed, slots] = streams(params, cfg, packed, None,
                                                slots)
        out[case] = {"solo": solo[arch, packed, slots],
                     "sharded": streams(params, cfg, packed, mesh_of(shape),
                                        slots)}
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
