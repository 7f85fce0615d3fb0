"""Cross-pod gradient sync with N:M-packed payloads and error feedback.

Counterpart of ``src/repro/optim/compress.py`` with the ``topk``
estimator: each pod keeps the n largest |g + err| of every m-group of
its gradient, ships them as bf16 values and uint8 offsets, and carries
what it did not ship (the pruned values and the bf16 rounding of the
shipped ones) in a fp32 residual; every pod decodes all payloads and
takes their mean.  ``GradCompressConfig``, ``compressible_shape``,
``plan_buckets``, ``compress_leaf``, ``err_state_elems``,
``cross_pod_sync`` and ``wire_bytes`` keep the reference's names and
semantics.

Here every pod's row lives on one card: gradients are pod-stacked
leaves (P, *shape) and the pod hop, an all_gather or ppermute of the
packed payload in the reference, is a no-op, because the payloads of
all P pods are already in one (P, Kc) tensor.  The process-group form
(NCCL between cards) is ROADMAP queue 1.

Layout.  The reference concatenates the compressible leaves into one
slab and cuts it into ``bucket_elems`` buckets.  An m-group never
straddles a leaf (a compressible leaf's size is a multiple of m) or a
bucket (buckets are m-aligned), so the result depends neither on the
slab's order nor on ``bucket_elems``, and the port never builds a slab,
which would be a 16 GB fp32 copy at qwen3-8b TRAIN_SYNC.  The EF
residual is one (P, width) fp32 tensor; leaf i of
``sgd.tree_leaves(master)`` that is compressible owns the columns
``plan.offsets[i] : + numel``, in that order, and the width is padded
to whole m-groups (with zeros, which compress to nothing).

On one card the unit of launch is the leaf: each compressible leaf's
whole (P, numel) view and its residual columns are one
``grad_compress`` launch, and its payload one ``grad_decompress_mean``
launch that writes the mean straight into the output leaf, in the
gradient's dtype (47 launches of each at TRAIN_SYNC).  The buckets of
``plan_sync`` (``SyncPlan.chunks``) give the same bits; they become the
unit of the wire again when the NCCL hop lands (ROADMAP queue 1 item
4), where a bucket is what one exchange carries.

What differs: the ``mvue`` estimator is not ported (ROADMAP queue 1);
the residual is updated in place (``cross_pod_sync`` consumes ``err``),
which saves a second 16 GB residual at TRAIN_SYNC; the two-pod fast
path of the reference (own payload from the EF identity, the peer's
decoded) is not a separate path: it equals the general mean bit for bit
(tests/test_torch_grad_compress.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.sparsity import nm_mask
from repro_torch.kernels import ops
from repro_torch.optim import sgd


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    """Knobs of the bucketed cross-pod sync.

    ``bucket_elems`` must be a multiple of m: a bucket boundary inside an
    m-group would split the group's top-n selection."""

    n: int = 2
    m: int = 8
    estimator: str = "topk"       # "topk" (EF); "mvue" is not ported
    bucket_elems: int = 1 << 16

    def __post_init__(self):
        if self.estimator not in ("topk", "mvue"):
            raise ValueError(f"unknown gradient estimator {self.estimator!r}")
        if self.estimator == "mvue":
            raise NotImplementedError(
                "the mvue estimator is not ported yet (ROADMAP queue 1)")
        if self.bucket_elems <= 0 or self.bucket_elems % self.m:
            raise ValueError(
                f"bucket_elems={self.bucket_elems} would split an M-group "
                f"(m={self.m}): bucket boundaries must be M-aligned")

    @classmethod
    def from_sparsity(cls, sp_cfg, **kw):
        return cls(n=sp_cfg.n, m=sp_cfg.m, **kw)


def compressible_shape(shape, m: int) -> bool:
    """Leaves whose size is a whole number of m-groups ride packed;
    scalars and ragged leaves (a (3,) bias) ride dense."""
    size = math.prod(shape)
    return len(shape) > 0 and size > 0 and size % m == 0


def plan_buckets(total: int, bucket_elems: int, m: int):
    """(start, stop) chunks of a flat range of ``total`` elements; every
    boundary m-aligned, a split that would cut a group refused."""
    if bucket_elems <= 0 or bucket_elems % m:
        raise ValueError(
            f"bucket_elems={bucket_elems} would split an M-group (m={m})")
    if total % m:
        raise ValueError(f"slab of {total} elems is not M-divisible (m={m})")
    return [(s, min(s + bucket_elems, total))
            for s in range(0, total, bucket_elems)]


def compress_leaf(g: torch.Tensor, err: torch.Tensor, n: int, m: int):
    """Single-leaf semantics: (what the wire carries, decoded to fp32;
    the new residual), groups along the flattened leaf.  Ragged leaves
    come back as they are."""
    if not compressible_shape(tuple(g.shape), m):
        return g, err
    flat = (g.to(torch.float32) + err.to(torch.float32)).reshape(-1, m)
    kept = torch.where(nm_mask(flat, n, m, axis=-1), flat, 0.0)
    sent = kept.to(torch.bfloat16).to(torch.float32)
    return sent.reshape(g.shape), (flat - sent).reshape(g.shape)


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """The plan of one sync, a function of the leaf shapes,
    ``bucket_elems`` and m alone.

    ``offsets[i]``: leaf i's first column in the residual, None for a
    ragged leaf; ``leaves``: (leaf, offset, numel) of each compressible
    leaf, one ``grad_compress`` and one ``grad_decompress_mean`` launch
    each; ``width``: the residual's width; ``chunks``: (leaf, start,
    stop) over the leaf's flat elements, the reference's buckets (made
    on request: 30,801 at TRAIN_SYNC, which the sync does not walk)."""

    offsets: tuple
    leaves: tuple
    width: int
    bucket_elems: int
    m: int

    @property
    def chunks(self) -> tuple:
        return tuple((i, s, e) for i, _, numel in self.leaves
                     for s, e in plan_buckets(numel, self.bucket_elems,
                                              self.m))

    @property
    def n_buckets(self) -> int:
        return sum(-(-numel // self.bucket_elems)
                   for _, _, numel in self.leaves)


def plan_sync(shapes, bucket_elems: int, m: int) -> SyncPlan:
    if bucket_elems <= 0 or bucket_elems % m:
        raise ValueError(
            f"bucket_elems={bucket_elems} would split an M-group (m={m})")
    offsets, leaves, total = [], [], 0
    for i, shape in enumerate(shapes):
        if not compressible_shape(tuple(shape), m):
            offsets.append(None)
            continue
        numel = math.prod(shape)
        offsets.append(total)
        leaves.append((i, total, numel))
        total += numel
    return SyncPlan(tuple(offsets), tuple(leaves), (total + m - 1) // m * m,
                    bucket_elems, m)


def err_state_elems(master, m: int) -> int:
    """Width of the (n_pods, width) residual: the compressible total of
    ``master``, padded to whole m-groups (one device per pod: the
    reference's S = 1)."""
    total = sum(x.numel() for x in sgd.tree_leaves(master)
                if compressible_shape(tuple(x.shape), m))
    return (total + m - 1) // m * m


def init_err(master, n_pods: int, m: int) -> torch.Tensor:
    """Zero residual (n_pods, err_state_elems) fp32 on master's device."""
    leaf = sgd.tree_leaves(master)[0]
    return torch.zeros((n_pods, err_state_elems(master, m)),
                       dtype=torch.float32, device=leaf.device)


def cross_pod_sync(grads, err: torch.Tensor, cfg: GradCompressConfig):
    """Pod mean of pod-stacked gradients through packed N:M payloads.

    ``grads``: a master-structured tree of (P, *shape) leaves, each
    pod's own gradient; ``err``: the (P, width) fp32 residual, updated
    in place.  Returns (the master-shaped mean gradients, each in its
    leaf's dtype; ``err``).  Each compressible leaf goes through one
    ``ops.grad_compress`` and one ``ops.grad_decompress_mean`` call
    (``SyncPlan.leaves``); ragged leaves take the fp32 mean over the
    pods.  CUDA tensors launch the kernels, CPU tensors run the plain
    versions.
    """
    leaves = sgd.tree_leaves(grads)
    pods = leaves[0].shape[0]
    plan = plan_sync([tuple(x.shape[1:]) for x in leaves],
                     cfg.bucket_elems, cfg.m)
    if tuple(err.shape) != (pods, plan.width) or err.dtype != torch.float32:
        raise ValueError(
            f"EF residual {tuple(err.shape)} {err.dtype} != ({pods}, "
            f"{plan.width}) float32: init it against the same master tree")
    for x in leaves:
        if x.shape[0] != pods or x.device != err.device:
            raise ValueError(
                f"gradient leaf {tuple(x.shape)} on {x.device} is not "
                f"stacked over {pods} pods on {err.device}")
    outs = []
    for x, off in zip(leaves, plan.offsets):
        if off is None:   # dense fp32 pod mean, as the reference's pmean
            acc = x[0].to(torch.float32)
            for p in range(1, pods):
                acc = acc + x[p].to(torch.float32)
            outs.append((acc / pods).to(x.dtype))
        else:
            outs.append(torch.empty(x.shape[1:], dtype=x.dtype,
                                    device=x.device))
    n, m = cfg.n, cfg.m
    for i, col, numel in plan.leaves:
        vals, idx, _ = ops.grad_compress(leaves[i].reshape(pods, numel),
                                         err[:, col:col + numel], n, m)
        ops.grad_decompress_mean(vals, idx, n, m, outs[i].view(-1))
        del vals, idx   # one leaf's payload alive at a time
    it = iter(outs)
    return sgd.tree_map(lambda _, x: next(it), grads), err


def wire_bytes(total: int, ragged: int, cfg: GradCompressConfig) -> int:
    """Per-pod bytes a process-group hop would carry per step: the packed
    payload (bf16 vals + uint8 idx, n per m-group) plus dense fp32
    raggeds."""
    groups = total // cfg.m
    return groups * cfg.n * (2 + 1) + ragged * 4
