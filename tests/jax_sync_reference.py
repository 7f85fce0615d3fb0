"""The reference's compressed cross-pod sync and compressed train step,
run in a fresh process on a forced P-device CPU mesh (pod=P, data=1,
model=1) of ``AxisType.Auto`` axes, for the port's parity tests.

  XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
      python tests/jax_sync_reference.py OUT.pkl MODE ARCH [FIELD=INT ...]

MODE ``train``: the arch's SMOKE config, three compressed BDWP 2:8 steps
(pre-generated, packed; the update through the interpret-mode Pallas
``fused_update``) from ``init_train_state(PRNGKey(0))`` on
``lm_stream(vocab, 4, 16)``: the initial and final states and the
per-step loss, aux and total.
MODE ``sync``: seeded random pod-stacked gradients of the compute tree's
dtypes (2 pods) and a nonzero residual at step 5; the reference's
``cross_pod_sync`` (topk, jitted) and its eager ``sgd.update(use_pallas=False)``.
MODE ``syncmvue``: the same gradients through ``cross_pod_sync`` with
the mvue estimator and the step's key, and the per-pod, per-bucket
uniforms it draws (rebuilt with the same ``fold_in`` chain), laid out
one a residual column group.  ``FIELD=INT`` replaces fields of the
SMOKE config (``n_layers=2``; hymba's ``ssm_head_dim=32``: four heads,
so its A_log, D and dt_bias are ragged per layer and whole m-groups
stacked).  Results are numpy trees, pickled.
"""

import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, Mesh

from repro.configs import get_arch
from repro.core.sparsity import SparsityConfig
from repro.data import synthetic as JD
from repro.models import transformer_lm as JT
from repro.optim import compress as C
from repro.optim import sgd as JSGD
from repro.sharding import rules as R
from repro.train import step as JST
from repro.train import trainer as JTR

PODS, BATCH, SEQ, STEPS, SYNC_STEP = 2, 4, 16, 3, 5


def main(dst, mode, arch, *fields):
    cfg = dataclasses.replace(get_arch(arch).smoke, **{
        k: int(v) for k, v in (f.split("=") for f in fields)})
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    mesh = Mesh(np.array(jax.devices()).reshape(PODS, 1, 1),
                ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    state = jax.jit(lambda k: JST.init_train_state(
        k, cfg, compress=True, sp_cfg=sp, pregen=True, pregen_pack=True,
        mesh=mesh))(jax.random.PRNGKey(0))
    host = lambda t: jax.tree.map(np.asarray, t)
    out = {"init": host(state)}
    if mode == "train":
        opt = JSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
        bundle = JST.build_lm_train(cfg, mesh, sp, opt, compress=True,
                                    donate=False, pregen=True,
                                    pregen_pack=True, use_pallas=True)
        final, hist = JTR.train_steps(
            bundle, state, JD.lm_stream(cfg.vocab, BATCH, SEQ), STEPS)
        out["metrics"] = {k: [float(h[k]) for h in hist]
                          for k in ("loss", "aux", "total")}
        out["final"] = host(final)
    else:
        state = dict(state, step=jnp.int32(SYNC_STEP))
        diff, meta = JST.split_compute(state["compute"])
        rng = np.random.default_rng(7)
        each = []
        for _ in range(PODS):
            g = jax.tree.map(lambda x: jnp.asarray(
                (rng.standard_normal(x.shape) * 1e-2).astype(np.float32)
            ).astype(x.dtype), diff)
            each.append(JSGD.pregen_grads(JST.merge_compute(g, meta)))
        grads = jax.tree.map(lambda *g: jnp.stack(g), *each)
        err = jnp.asarray((rng.standard_normal(state["err"].shape)
                           * 1e-3).astype(np.float32))
        specs = R.nm_params_pspecs(JT.init(jax.random.PRNGKey(0), cfg,
                                           abstract=True)[1], R.TRAIN_RULES,
                                   state["master"], mesh, sp)
        out.update(grads=host(grads), err=host(err))
        if mode == "sync":
            gc = C.GradCompressConfig.from_sparsity(sp)
            mean, new_err = jax.jit(lambda g, e: C.cross_pod_sync(
                g, e, mesh, specs, gc))(grads, err)
            opt = JSGD.SGDConfig(lr=0.1, warmup_steps=100)
            new, comp = JSGD.update(JST.state_core(state), mean, opt, sp,
                                    prev_compute=state["compute"],
                                    pregen=True, pack=True,
                                    use_pallas=False)
            out.update(mean=host(mean), new_err=host(new_err),
                       new=host(new), compute=host(comp))
        else:
            gc = C.GradCompressConfig.from_sparsity(sp, estimator="mvue")
            key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), SYNC_STEP)
            mean, new_err = jax.jit(lambda g, e, k: C.cross_pod_sync(
                g, e, mesh, specs, gc, k))(grads, err, key)
            width = err.shape[1]
            us = []
            for p in range(PODS):
                kp = jax.random.fold_in(key, p)
                us.append(np.concatenate([np.asarray(jax.random.uniform(
                    jax.random.fold_in(kp, b), (1, (e - s) // sp.m, 1),
                    dtype=jnp.float32)).reshape(-1)
                    for b, (s, e) in enumerate(C.plan_buckets(
                        width, gc.bucket_elems, sp.m))]))
            out.update(mean=host(mean), new_err=host(new_err),
                       uniforms=np.stack(us))
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
