"""The JAX reference's side of the image-model parity tests, run in a
subprocess (``tests/test_torch_convnets.py``,
``tests/test_torch_paper_train.py``):

    python tests/jax_paper_reference.py OUT.pkl NAME...

with ``JAX_PLATFORMS=cpu`` and ``XLA_FLAGS`` set to ``FLAGS``, so that
the compiled reference rounds as its source reads, as the eager
reference and the port do:

  * ``--xla_allow_excess_precision=false``: by default XLA's CPU
    compiler keeps excess precision across bf16 casts; the compiled
    reference then feeds each conv the unrounded fp32 BatchNorm output
    (XLA runs bf16 convs in fp32 on the CPU), and its ResNet9 logits
    move by 1.6% of their largest magnitude from the eager reference's
    (with the flag they are bitwise equal);
  * ``--xla_cpu_max_isa=AVX``: no fused multiply-add instructions, so
    the compiled update does not contract ``mu*v + g`` and
    ``w - lr*v'`` (``tests/test_torch_train.py`` runs it eagerly
    instead, which takes ten times as long on the CPU).

The flags must be set before JAX starts, hence the subprocess.

A NAME of ``MODELS`` (ResNet9 at width 16, VGG19, a 2-block ViT,
ResNet18 at width 16, ResNet50 at width 8) gives that model's master
params, the pre-generated packed
compute tree (ResNet9, VGG19, ViT), one batch, the logits and
master-shaped gradients (of the compute tree's float leaves, or of the
fp32 master on the MaskedOp path for ResNet18/50), and one
``sgd.update(pregen=True, pack=True, use_pallas=False)`` (its jnp path)
from step 5 with those gradients (random ones for ResNet18), with its
state.  Whether ResNet18/50's forward on a pre-generated tree raises is
recorded too (traced, not run).  For VGG19 also each conv-BN-ReLU layer
alone (``layers``): its input in the reference's forward, a random
cotangent, and the layer's output and gradients (of the input, the
conv's ``bp`` and the norm's scale and bias); and the logits of the
same batch with one pixel moved by one bf16 ulp (``logits_nudged``).
At init VGG19 is chaotic: that nudge moves its logits by about 3% of
their largest magnitude, as much as the eager and the compiled
reference differ, so whole-model gradients say little there.

The NAME ``train`` gives three steps of ResNet9 (width 8) and of the small ViT as
the reference composes them (``tests/test_pregen.py``): jitted loss and
gradients on the compute tree, then ``sgd.update(pregen=True, pack=True,
use_pallas=True)`` (interpret-mode Pallas ``fused_update``), jitted;
the initial state and the losses.

The NAME ``legacy`` gives three steps of the legacy dataflow as
``examples/paper_loss_curves.py`` composes it (jitted loss and
gradients on the fp32 master, then ``sgd.update`` with ``pregen=False``,
jitted), at ``TRAIN_OPT``: ResNet9 (width 16, 4 images of 16 x 16) under
each of ``METHODS`` and ResNet18 (width 16, 2 images of 32 x 32) under
2:8 bdwp; the state before each step and after the last, the losses,
and each step's master-shaped gradients.

Everything comes back pickled as numpy trees (``PregenOp`` leaves keep
their class).
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import operand as JO
from repro.core.sparsity import SparsityConfig
from repro.data import synthetic as JD
from repro.models import convnets as JC
from repro.optim import sgd as JSGD
from repro.train import step as JST

FLAGS = "--xla_allow_excess_precision=false --xla_cpu_max_isa=AVX"
SP = SparsityConfig(n=2, m=8, method="bdwp")
VIT_SMALL = JC.ViTConfig(image=8, patch=4, d_model=64, n_layers=2, n_heads=4,
                         d_ff=128, num_classes=10)
# warmup over a power of two: compiled, XLA turns ``lr * step / warmup``
# into a product with the reciprocal, which is exact only then
OPT = JSGD.SGDConfig(lr=0.1, warmup_steps=64)
TRAIN_OPT = JSGD.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
TRAIN_STEPS = 3

# name -> (init, apply, num_classes, batch, image, pre-generated?)
MODELS = {
    "resnet9": (lambda k: JC.resnet9_init(k, 10, 16),
                lambda p, x: JC.resnet9_apply(p, x, SP), 10, 4, 16, True),
    "vgg19": (lambda k: JC.vgg19_init(k, 100),
              lambda p, x: JC.vgg19_apply(p, x, SP), 100, 2, 32, True),
    "vit": (lambda k: JC.vit_init(k, VIT_SMALL),
            lambda p, x: JC.vit_apply(p, x, VIT_SMALL, SP), 10, 4, 8, True),
    "resnet18": (lambda k: JC.resnet_init(k, 18, 16, 16),
                 lambda p, x: JC.resnet_apply(p, x, 18, SP, 16), 16, 2, 32,
                 False),
    "resnet50": (lambda k: JC.resnet_init(k, 50, 16, 8),
                 lambda p, x: JC.resnet_apply(p, x, 50, SP, 8), 16, 2, 32,
                 False),
}


def host(tree):
    return jax.tree.map(np.asarray, tree)


def loss_of(logits, y):
    logz = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
    return (logz - gold).mean()


def grads_fn(apply, pregen):
    """jitted (tree, x, y) -> (loss, logits, master-shaped gradients)."""
    def on_master(p, x, y):
        def f(q):
            logits = apply(q, x.astype(jnp.bfloat16))
            return loss_of(logits, y), logits
        (loss, logits), g = jax.value_and_grad(f, has_aux=True)(p)
        return loss, logits, g

    def on_compute(compute, x, y):
        diff, meta = JST.split_compute(compute)

        def f(d):
            logits = apply(JST.merge_compute(d, meta), x.astype(jnp.bfloat16))
            return loss_of(logits, y), logits
        (loss, logits), g = jax.value_and_grad(f, has_aux=True)(diff)
        return loss, logits, JSGD.pregen_grads(JST.merge_compute(g, meta))

    return jax.jit(on_compute if pregen else on_master)


@jax.jit
def update_jnp(state, grads):
    return JSGD.update(JST.state_core(state), grads, OPT, SP,
                       prev_compute=state["compute"], pregen=True, pack=True,
                       use_pallas=False)


def model(name):
    init, apply, classes, batch, image, pregen = MODELS[name]
    # the fp32 master, as init_state casts it (ResNet's int _meta too)
    master = JSGD.init_state(jax.jit(init)(jax.random.PRNGKey(0)))["master"]
    x, y = JD.image_batch(JD.ImageTaskConfig(
        image=image, num_classes=classes, batch=batch), 0)
    compute = jax.jit(lambda m: JSGD.pregen_tree(m, SP, pack=True))(
        master)
    rec = {"master": host(master), "x": x, "y": y}
    _, logits, grads = grads_fn(apply, pregen)(
        compute if pregen else master, x, y)
    rec.update(logits=np.asarray(logits), grads=host(grads))
    if pregen:
        rec["compute"] = host(compute)
    else:
        try:
            jax.eval_shape(apply, compute, jnp.asarray(x, jnp.bfloat16))
            rec["pregen_forward_error"] = None
        except AttributeError as e:
            rec["pregen_forward_error"] = str(e)
    if name == "vgg19":
        rec.update(vgg19_layers(compute, x))
    if pregen or name == "resnet18":
        if not pregen:
            rng = np.random.default_rng(2)
            grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
                a.shape), jnp.bfloat16), master)
        rng = np.random.default_rng(3)
        state = {"master": master,
                 "momentum": jax.tree.map(lambda a: jnp.asarray(
                     rng.standard_normal(a.shape) * 0.01, jnp.float32),
                     master),
                 "step": jnp.int32(5), "compute": compute}
        new, comp = update_jnp(state, grads)
        rec["update"] = {"state": host(state), "grads": host(grads),
                         "new": host(new), "compute": host(comp)}
    return rec


def vgg19_layers(compute, x):
    @jax.jit
    def layer(op, w, bn, h):
        """conv-BN-ReLU of h, differentiable in the conv's ``bp`` (or its
        plain weight: ``head0``), the norm and h."""
        if op is not None:
            w = JO.PregenOp(bp=w, vals=op.vals, idx=op.idx, mask=op.mask,
                            cfg=op.cfg, idx_bits=op.idx_bits)
        return jax.nn.relu(JC._bn_apply(bn, JC._nm_conv_auto(
            {"w": w}, h, SP, "head0" if op is None else "conv")))

    rng = np.random.default_rng(4)
    out, cin = [], 3
    h = jnp.asarray(x, jnp.bfloat16)
    for i, v in enumerate(JC._VGG19):
        if v == "M":
            h = jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                      (1, 2, 2, 1), "VALID")
            continue
        name = "head0" if cin == 3 else f"conv{i}"
        w = compute[name]["conv"]["w"]
        op = w if isinstance(w, JO.PregenOp) else None
        y, vjp = jax.vjp(lambda w, bn, h, op=op: layer(op, w, bn, h),
                         w if op is None else op.bp, compute[name]["bn"], h)
        g = jnp.asarray(rng.standard_normal(y.shape), jnp.bfloat16)
        dbp, dbn, dh = vjp(g)
        out.append({"name": name, "x": np.asarray(h), "y": np.asarray(y),
                    "g": np.asarray(g), "dx": np.asarray(dh),
                    "dbp": np.asarray(dbp), "dbn": host(dbn)})
        h, cin = y, v
    nudged = np.array(jnp.asarray(x, jnp.bfloat16))
    nudged.view(np.uint16).flat[7] += 1
    logits = jax.jit(MODELS["vgg19"][1])(compute, jnp.asarray(nudged))
    return {"layers": out, "logits_nudged": np.asarray(logits)}


def train():
    out = {}
    for name in ("resnet9", "vit"):
        init, apply, classes, batch, image, _ = MODELS[name]
        master = jax.jit(init)(jax.random.PRNGKey(0))
        state = JSGD.init_state(master)
        state["compute"] = JSGD.pregen_tree(state["master"], SP, pack=True)
        out[name] = {"init": host(state), "losses": []}
        grads = grads_fn(apply, True)

        @jax.jit
        def update(state, g):
            new, comp = JSGD.update(JST.state_core(state), g, TRAIN_OPT, SP,
                                    prev_compute=state["compute"],
                                    pregen=True, pack=True, use_pallas=True)
            return dict(new, compute=comp)

        icfg = JD.ImageTaskConfig(image=image, num_classes=classes,
                                  batch=batch)
        for step in range(TRAIN_STEPS):
            x, y = JD.image_batch(icfg, step)
            loss, _, g = grads(state["compute"], x, y)
            state = update(state, g)
            out[name]["losses"].append(float(loss))
    return out


METHODS = ("dense", "srste", "sdgp", "sdwp", "bdwp")
# (model, method) -> (init, apply, num_classes, batch, image) of the
# legacy runs
LEGACY = {
    **{("resnet9", meth): (
        lambda k: JC.resnet9_init(k, 10, 16),
        lambda p, x, sp: JC.resnet9_apply(p, x, sp), 10, 4, 16)
       for meth in METHODS},
    ("resnet18", "bdwp"): (
        lambda k: JC.resnet_init(k, 18, 16, 16),
        lambda p, x, sp: JC.resnet_apply(p, x, 18, sp, 16), 16, 2, 32),
}


def legacy():
    out = {}
    for (name, method), (init, apply, classes, batch, image) in \
            LEGACY.items():
        sp = SparsityConfig(n=2, m=8, method=method)
        state = JSGD.init_state(jax.jit(init)(jax.random.PRNGKey(0)))
        run = {"states": [host(state)], "losses": [], "grads": []}

        @jax.jit
        def step(state, x, y, apply=apply, sp=sp):
            def f(master):
                return loss_of(apply(master, x.astype(jnp.bfloat16), sp), y)
            loss, g = jax.value_and_grad(f)(state["master"])
            new, _ = JSGD.update(state, g, TRAIN_OPT, sp)
            return new, loss, g

        icfg = JD.ImageTaskConfig(image=image, num_classes=classes,
                                  batch=batch)
        for i in range(TRAIN_STEPS):
            x, y = JD.image_batch(icfg, i)
            state, loss, g = step(state, jnp.asarray(x), jnp.asarray(y))
            run["states"].append(host(state))
            run["losses"].append(float(loss))
            run["grads"].append(host(g))
        out[f"{name}/{method}"] = run
    return out


if __name__ == "__main__":
    dst, names = sys.argv[1], sys.argv[2:]
    runs = {"train": train, "legacy": legacy}
    result = {n: runs[n]() if n in runs else model(n) for n in names}
    with open(dst, "wb") as f:
        pickle.dump(result, f)
