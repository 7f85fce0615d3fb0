"""PyTorch + CUDA port of the N:M sparse system, held against ``src/repro/``.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core/sparsity``, ``core/operand``, ``kernels/ops``,
``models/*``, ``serve/*``, ``train/step``) with PyTorch idiom inside:
plain functions on tensors, per-layer parameter lists where the
reference scans stacked leaves, an explicit ``device`` argument and
explicit ``torch.Generator``s.  It imports ``torch`` and never ``jax``,
and nothing of ``repro`` — modules it needs from there that import no
JAX (``serve/cache_store``, ``configs``) are copied, not imported.

Slice 1 covers packed N:M serving of the dense GQA transformer LM
(qwen3-8b): ``serve.engine.ServeEngine`` down to the hand-written
Hopper kernel ``kernels/csrc/nm_spmm.cu``.  Training is not ported yet.
"""
