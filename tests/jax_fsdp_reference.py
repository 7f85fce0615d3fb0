"""The reference's sharded training step on a forced D-device CPU mesh
(data=D, model=1) of ``AxisType.Auto`` axes, for the port's FSDP tests.

  XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
      python tests/jax_fsdp_reference.py OUT.pkl BATCH SEQ STEPS ARCH...

Each arch's SMOKE config, BDWP 2:8, pre-generated packed operands, the
optimizer of the reference's own sharded-vs-single test
(``tests/test_spmd.py``: lr 0.1, 8 total steps); ``init_train_state``
from ``PRNGKey(0)`` on the mesh, then ``build_lm_train`` over STEPS
batches of ``lm_stream(vocab, BATCH, SEQ)``.  Writes every arch's
initial state (numpy trees, pickled; {arch: state}) to OUT.pkl.init as
soon as it has them, then {arch: initial and final states and the
per-step losses and aux} to OUT.pkl.
"""

import os
import pickle
import sys

import jax
import numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding

from repro.configs import get_arch
from repro.core.sparsity import SparsityConfig
from repro.data import synthetic as JD
from repro.optim import sgd as JSGD
from repro.train import step as JST
from repro.train import trainer as JTR


def main(dst, batch, seq, steps, *archs):
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    opt = JSGD.SGDConfig(lr=0.1, total_steps=8)
    n = jax.device_count()
    mesh = Mesh(np.array(jax.devices()).reshape(n, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    host = lambda t: jax.tree.map(np.asarray, t)
    runs = {}
    for arch in archs:
        cfg = get_arch(arch).smoke
        bundle = JST.build_lm_train(cfg, mesh, sp, opt, donate=False,
                                    pregen=True, pregen_pack=True)
        state = JST.init_train_state(jax.random.PRNGKey(0), cfg, sp_cfg=sp,
                                     pregen=True, pregen_pack=True,
                                     mesh=mesh)
        runs[arch] = (cfg, bundle,
                      jax.device_put(state, bundle.state_shardings))
    out = {arch: {"init": host(state)} for arch, (_, _, state)
           in runs.items()}
    with open(dst + ".init.tmp", "wb") as f:  # the port starts from them
        pickle.dump({arch: o["init"] for arch, o in out.items()}, f)
    os.replace(dst + ".init.tmp", dst + ".init")
    for arch, (cfg, bundle, state) in runs.items():
        sh = {k: NamedSharding(mesh, ps)
              for k, ps in bundle.input_pspecs.items()}
        final, hist = JTR.train_steps(
            bundle, state, JD.lm_stream(cfg.vocab, int(batch), int(seq),
                                        shardings=sh), int(steps))
        out[arch]["losses"] = [float(h["loss"]) for h in hist]
        out[arch]["aux"] = [float(h["aux"]) for h in hist]
        out[arch]["final"] = host(final)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
