"""PyTorch + CUDA port of the N:M sparse system, held against ``src/repro/``.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core/sparsity``, ``core/operand``, ``kernels/ops``,
``models/*``, ``optim/sgd``, ``serve/*``, ``train/*``, ``data/synthetic``)
with PyTorch idiom inside:
plain functions on tensors, per-layer parameter lists where the
reference scans stacked leaves, an explicit ``device`` argument and
explicit ``torch.Generator``s.  It imports ``torch`` and never ``jax``,
and nothing of ``repro`` — modules it needs from there that import no
JAX (``serve/cache_store``, ``configs``) are copied, not imported.

Slice 1 covers packed N:M serving of the dense GQA transformer LM
(qwen3-8b): ``serve.engine.ServeEngine`` down to the hand-written
Hopper kernel ``kernels/csrc/nm_spmm.cu``.  Slice 2 covers its BDWP
training with pre-generated, SORE-packed FF operands:
``train.trainer.train_steps`` over ``train.step.lm_train_step``, whose
forward runs ``nm_spmm`` and whose update (``optim.sgd.update``) runs
the hand-written ``kernels/csrc/fused_update.cu``.  Slice 3 adds the
compressed cross-pod gradient sync (``lm_train_step(compress=True)`` →
``optim.compress.cross_pod_sync``, all pods on one card) on the
hand-written ``kernels/csrc/grad_compress.cu``, and ``train.trainer.fit``
with checkpoints (``train.checkpoint``) and fault tolerance
(``train.fault``).  Later slices add the paper's models, the other
archs of the reference's registry and, in slice 16, the compressed sync
for every LM arch, the mvue estimator, the pod hop across processes
(``cross_pod_sync(group=...)``) and the training launcher
(``launch.train``).
"""
