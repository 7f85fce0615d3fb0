"""The reference's continuous-batching engine over a forced 4-device CPU
mesh (data=1, model=M) of ``AxisType.Auto`` axes, for the port's
tensor-parallel serving tests.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      python tests/jax_tp_serve_reference.py OUT.pkl ARCH:M:packed|masked...

The workload of the reference's own sharded-vs-solo test
(``tests/test_spmd.py``'s ``TestServeParity``): SMOKE weights from
``PRNGKey(0)`` in bf16, 2:8 bdwp, ``ServeConfig(n_slots=4, max_len=32,
prompt_bucket=12)``, prompts of (4, 7, 11, 5, 9) tokens from
``default_rng(3)``, 8 new tokens each.  Each case (arch, "model" ranks
M, packed u4 or masked) runs over its mesh, and each (arch, packing)
once solo.  Writes each arch's weights (numpy trees, pickled; {arch:
params}) to OUT.pkl.params as soon as it has them, then {(arch, M,
packed): {"solo": streams, "sharded": streams}} to OUT.pkl.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, Mesh

from repro.configs import get_arch
from repro.core.sparsity import SparsityConfig
from repro.models import transformer_lm as T
from repro.serve import ServeConfig, ServeEngine

LENGTHS = (4, 7, 11, 5, 9)
NEW = 8


def streams(params, cfg, packed, mesh):
    sc = ServeConfig(n_slots=4, max_len=32, prompt_bucket=12, packed=packed)
    eng = ServeEngine(params, cfg, SparsityConfig(n=2, m=8, method="bdwp"),
                      sc, mesh=mesh)
    rng = np.random.default_rng(3)
    for length in LENGTHS:
        eng.submit(rng.integers(0, cfg.vocab, length).tolist(),
                   max_new_tokens=NEW)
    return eng.run()


def main(dst, *cases):
    cases = [(a, int(m), p == "packed")
             for a, m, p in (c.split(":") for c in cases)]
    weights = {}
    for arch, _, _ in cases:
        if arch not in weights:
            params, _ = T.init(jax.random.PRNGKey(0), get_arch(arch).smoke)
            weights[arch] = jax.tree.map(lambda w: w.astype(jnp.bfloat16),
                                         params)
    with open(dst + ".params.tmp", "wb") as f:   # the port starts from them
        pickle.dump(jax.tree.map(np.asarray, weights), f)
    os.replace(dst + ".params.tmp", dst + ".params")
    out, solo = {}, {}
    for arch, model, packed in cases:
        cfg, params = get_arch(arch).smoke, weights[arch]
        mesh = Mesh(np.array(jax.devices()[:model]).reshape(1, model),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        if (arch, packed) not in solo:
            solo[arch, packed] = streams(params, cfg, packed, None)
        out[arch, model, packed] = {
            "solo": solo[arch, packed],
            "sharded": streams(params, cfg, packed, mesh)}
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
