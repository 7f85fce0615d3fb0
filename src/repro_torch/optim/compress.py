"""Cross-pod gradient sync with N:M-packed payloads.

Counterpart of ``src/repro/optim/compress.py``.  Two estimators, as in
the reference: ``topk`` keeps the n largest |g + err| of every m-group,
ships them as bf16 values and uint8 offsets, and carries what it did not
ship (the pruned values and the bf16 rounding of the shipped ones) in a
fp32 residual; ``mvue`` (``mvue_probs``, ``_systematic_sample``,
``mvue_compress``) samples exactly n slots a group with water-filled
inclusion probabilities, rescales the kept values by 1/p and keeps no
residual.  Every pod decodes all payloads and takes their mean.
``GradCompressConfig``, ``compressible_shape``, ``plan_buckets``,
``compress_leaf``, ``slab_shards``, ``local_block_shape``,
``err_state_elems`` (with its mesh form), ``cross_pod_sync`` and
``wire_bytes`` keep the reference's names and semantics.

On a mesh (``sharding.fsdp``) each rank runs the process form on its
blocks of every leaf, with its own (1, local width) residual row: its
groups run along its blocks, as the reference's device-local slabs lay
them out, and its payloads cross the "pod" group only.

Two forms of the pod hop.  On one card every pod's row lives in one
tensor: gradients are pod-stacked leaves (P, *shape), the residual is
(P, width), and the hop is a no-op, because the payloads of all P pods
are already in one (P, Kc) tensor.  Across processes (``group=``, a
``torch.distributed`` group, one process per pod) each process holds its
pod's (1, *shape) leaves and its (1, width) residual row, so the
residual is sharded by pod; the packed payload of each unit is gathered
over the group (the bf16 values bitcast to bytes, as the reference
bitcasts them to u16, and the u8 offsets), and ragged leaves are gathered and
summed in pod order, so the mean is bitwise the one-card form's for any
P (a backend's ``all_reduce`` order is not fixed).  ``hop_stats``
counts the gathers and the bytes they carried.

Layout.  The reference concatenates the compressible leaves of its
layer-stacked tree into one slab and cuts it into ``bucket_elems``
buckets.  An m-group never straddles a leaf (a compressible leaf's size
is a multiple of m) or a bucket (buckets are m-aligned), so the result
depends neither on the slab's order nor on ``bucket_elems``, and the
port never builds a slab, which would be a 16 GB fp32 copy at qwen3-8b
TRAIN_SYNC.  The residual is one (rows, width) fp32 tensor; the unit of
launch is a compressible leaf of ``sgd.tree_leaves(master)``, whose
columns are ``plan.offsets[i] : + numel``, in that order, with one
exception: the per-layer leaves of a block list whose own size is not a
whole number of m-groups while their stack's is (hymba's (50,) A_log, D
and dt_bias, 32 layers) form one unit, their L layers in a row, because
the reference groups the stacked leaf across layers.  The width is padded
to whole m-groups (with zeros, which compress to nothing).  The buckets
of ``plan_sync`` (``SyncPlan.chunks``) give the same bits.

mvue's draws.  The reference draws one uniform per m-group from
``fold_in(fold_in(fold_in(PRNGKey(0x5EED), step), pod), bucket)``, which
the port cannot reproduce; it draws them from a ``torch.Generator`` on
the gradients' device seeded from (0x5EED, step, pod) (``mvue_seed``),
one ``torch.rand`` a unit in column order, so that the one-card form and
the process form draw the same uniforms for the same pod.
``cross_pod_sync(uniforms=...)`` takes them as a tensor instead, laid
out one a residual column group.

What differs: the residual is updated in place (``cross_pod_sync``
consumes ``err``), which saves a second 16 GB residual at TRAIN_SYNC;
the two-pod fast path of the reference (own payload from the EF
identity, the peer's decoded) is not a separate path: it equals the
general mean bit for bit (tests/test_torch_grad_compress.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

from repro_torch.core.sparsity import nm_mask, nm_pack_from_mask
from repro_torch.kernels import ops
from repro_torch.optim import sgd


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    """Knobs of the bucketed cross-pod sync.

    ``bucket_elems`` must be a multiple of m: a bucket boundary inside an
    m-group would split the group's top-n selection."""

    n: int = 2
    m: int = 8
    estimator: str = "topk"       # "topk" (EF) | "mvue" (unbiased, no EF)
    bucket_elems: int = 1 << 16

    def __post_init__(self):
        if self.estimator not in ("topk", "mvue"):
            raise ValueError(f"unknown gradient estimator {self.estimator!r}")
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


# ---------------------------------------------------------------------------
# MVUE estimator (arXiv 2203.10991)
# ---------------------------------------------------------------------------


def _running_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sums along the last (group) axis, added left to right,
    as ``jnp.cumsum`` and ``jnp.sum`` take a group on XLA's CPU: the same
    bits on the card and on the CPU, where a reduction kernel of either
    may take its own order."""
    run, out = x[..., 0], [x[..., 0]]
    for j in range(1, x.shape[-1]):
        run = run + x[..., j]
        out.append(run)
    return torch.stack(out, dim=-1)


def _group_sum(x: torch.Tensor) -> torch.Tensor:
    return _running_sums(x)[..., -1:]


def mvue_probs(a: torch.Tensor, n: int) -> torch.Tensor:
    """Water-filled inclusion probabilities per group: a (..., m)
    nonnegative scores -> p = min(1, a/tau) with tau chosen so that
    sum(p) = n (a group with fewer than n nonzeros gets p = 1 on each);
    the fixed point is reached in n rounds, as the reference computes
    it."""
    sat = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    tau = _group_sum(a) / n
    for _ in range(n):
        denom = n - sat.sum(-1, keepdim=True)
        rest = _group_sum(torch.where(sat, 0.0, a))
        ok = denom > 0
        tau = torch.where(ok, rest / torch.clamp(denom, min=1), tau)
        sat = torch.where(ok, a >= tau, sat)
    p = torch.where(sat, 1.0, torch.where(
        tau > 0, a / torch.clamp(tau, min=1e-38), 0.0))
    return torch.where(a > 0, torch.clamp(p, 0.0, 1.0), 0.0)


def _systematic_sample(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Systematic sampling with one uniform a group: ``u`` (..., 1);
    position i is drawn iff floor(c_i - u) > floor(c_{i-1} - u) on the
    cumulative sum c of ``p`` (..., m).  Every p = 1 entry is drawn."""
    c = _running_sums(p)
    f = torch.floor(c - u)
    prev = torch.cat([torch.floor(-u).expand(f[..., :1].shape),
                      f[..., :-1]], dim=-1)
    return f > prev


def mvue_compress(t: torch.Tensor, n: int, m: int, u: torch.Tensor):
    """(..., L) -> packed (bf16 vals, uint8 idx) along the last axis, one
    uniform of ``u`` (..., L/m) a group.  Drawn values are rescaled by
    1/p; a group short of n draws is padded with its earliest undrawn
    slots at value 0, so the payload always holds n slots a group."""
    g = t.reshape(*t.shape[:-1], t.shape[-1] // m, m).to(torch.float32)
    p = mvue_probs(g.abs(), n)
    sel = _systematic_sample(p, u.reshape(*g.shape[:-1], 1).to(p.dtype))
    mask = nm_mask(torch.where(sel, 1.0, 0.0), n, m)
    est = torch.where(sel, g / torch.clamp(p, min=1e-38), 0.0)
    vals, idx = nm_pack_from_mask(est.reshape(t.shape),
                                  mask.reshape(t.shape), n, m)
    return vals.to(torch.bfloat16), idx


def mvue_seed(step: int, pod: int) -> int:
    """The seed of pod ``pod``'s mvue draws at optimizer step ``step``:
    (0x5EED, step, pod) hashed to 63 bits."""
    key = f"{0x5EED}:{int(step)}:{int(pod)}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little") >> 1


def mvue_uniforms(plan, step: int, pod: int, device) -> torch.Tensor:
    """Pod ``pod``'s (width/m,) fp32 uniforms at ``step``: one
    ``torch.rand`` a unit of ``plan`` in column order from a generator on
    ``device`` seeded with ``mvue_seed(step, pod)`` (the pad's groups
    get zeros)."""
    gen = torch.Generator(device=device).manual_seed(mvue_seed(step, pod))
    out = torch.zeros(plan.width // plan.m, dtype=torch.float32,
                      device=device)
    for _, col, numel in plan.units:
        out[col // plan.m:(col + numel) // plan.m] = torch.rand(
            numel // plan.m, generator=gen, device=device)
    return out


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """The plan of one sync, a function of the leaf shapes, the tree's
    layer stacks, ``bucket_elems`` and m alone.

    ``offsets[i]``: leaf i's first column in the residual, None for a
    ragged leaf; ``leaves``: (leaf, offset, numel) of each compressible
    leaf; ``stacks``: (leaves, offset, numel of one) of each layer stack
    whose per-layer leaves are ragged and whose stack is not, its layers
    in a row; ``units``: both as (leaves, offset, numel), in column
    order, one ``grad_compress`` and one ``grad_decompress_mean`` launch
    each; ``width``: the residual's width; ``chunks``: (the unit's
    leaves, start, stop) over the unit's flat elements, the reference's
    buckets (made
    on request: 30,801 at TRAIN_SYNC, which the sync does not walk)."""

    offsets: tuple
    leaves: tuple
    width: int
    bucket_elems: int
    m: int
    stacks: tuple = ()

    @property
    def units(self) -> tuple:
        out = [((i,), col, numel) for i, col, numel in self.leaves]
        out += [(members, col, numel * len(members))
                for members, col, numel in self.stacks]
        return tuple(sorted(out, key=lambda u: u[1]))

    @property
    def chunks(self) -> tuple:
        return tuple((members, s, e) for members, _, numel in self.units
                     for s, e in plan_buckets(numel, self.bucket_elems,
                                              self.m))

    @property
    def n_buckets(self) -> int:
        return sum(-(-numel // self.bucket_elems)
                   for _, _, numel in self.units)


def leaf_families(tree) -> list:
    """For each leaf of ``sgd.tree_leaves(tree)``: its name (``tree_map``'s,
    list indices dropped) when it sits in a list of per-layer blocks, the
    reference's stacked leaf it is one layer of; else None."""
    out = []

    def walk(node, path, listed):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), listed)
        elif isinstance(node, list):
            for v in node:
                walk(v, path, True)
        else:
            out.append("/".join(path) if listed else None)

    walk(tree, (), False)
    return out


def plan_sync(shapes, bucket_elems: int, m: int, families=None) -> SyncPlan:
    """The plan of leaves of ``shapes``; ``families`` (``leaf_families``)
    names the layer stacks."""
    if bucket_elems <= 0 or bucket_elems % m:
        raise ValueError(
            f"bucket_elems={bucket_elems} would split an M-group (m={m})")
    shapes = [tuple(x) for x in shapes]
    members = {}
    for i, fam in enumerate(families or ()):
        if fam is not None:
            members.setdefault(fam, []).append(i)
    offsets = [None] * len(shapes)
    leaves, stacks, total = [], [], 0
    for i, shape in enumerate(shapes):
        numel = math.prod(shape)
        if compressible_shape(shape, m):
            offsets[i] = total
            leaves.append((i, total, numel))
            total += numel
            continue
        fam = families[i] if families else None
        group = members.get(fam, ())
        if not group or group[0] != i or numel == 0 \
                or numel * len(group) % m:
            continue
        if any(shapes[k] != shape for k in group):
            raise ValueError(f"layer stack {fam}: per-layer shapes differ")
        for j, k in enumerate(group):
            offsets[k] = total + j * numel
        stacks.append((tuple(group), total, numel))
        total += numel * len(group)
    return SyncPlan(tuple(offsets), tuple(leaves), (total + m - 1) // m * m,
                    bucket_elems, m, tuple(stacks))


def plan_for(tree, bucket_elems: int, m: int, stacked: bool = False):
    """``plan_sync`` of ``tree``'s leaves (``stacked``: pod-stacked leaves
    (P, *shape), the plan of their shape)."""
    leaves = sgd.tree_leaves(tree)
    return plan_sync([tuple(x.shape[1:] if stacked else x.shape)
                      for x in leaves], bucket_elems, m,
                     leaf_families(tree))


def slab_shards(mesh) -> int:
    """S: the ranks a pod holds (every axis but "pod"), each with its
    own slab of the residual."""
    return math.prod(s for a, s in mesh.shape.items() if a != "pod")


def local_block_shape(shape, spec, mesh) -> tuple:
    """A leaf's block shape on one rank under its spec; raises when a
    cut dim does not split evenly."""
    out = []
    for i, d in enumerate(shape):
        entry = spec[i] if spec is not None and i < len(spec) else None
        split = 1
        for ax in (() if entry is None else entry if isinstance(entry, tuple)
                   else (entry,)):
            split *= mesh.shape.get(ax, 1)
        if d % split:
            raise ValueError(f"dim {d} of {tuple(shape)} not divisible by "
                             f"its {split}-way shard ({spec})")
        out.append(d // split)
    return tuple(out)


def err_state_elems(master, m: int, mesh=None, grad_pspecs=None) -> int:
    """Width of the (n_pods, width) residual: the compressible total of
    ``master`` (layer stacks included), padded to whole m-groups (one
    rank per pod: the reference's S = 1).  With ``mesh`` and the
    master's resolved specs ``grad_pspecs``: the rank-local slab's
    padded width (its blocks, ``local_block_shape``; a block that is not
    whole m-groups is ragged there) times ``slab_shards``, the
    reference's T_loc_pad * S."""
    if mesh is None or grad_pspecs is None:
        return plan_for(master, m, m).width
    local = sgd.tree_map(lambda _, x, spec: torch.empty(
        local_block_shape(tuple(x.shape), spec, mesh), device="meta"),
        master, grad_pspecs)
    return plan_for(local, m, m).width * slab_shards(mesh)


def init_err(master, n_pods: int, m: int) -> torch.Tensor:
    """Zero residual (n_pods, err_state_elems) fp32 on master's device."""
    leaf = sgd.tree_leaves(master)[0]
    return torch.zeros((n_pods, err_state_elems(master, m)),
                       dtype=torch.float32, device=leaf.device)


# ---------------------------------------------------------------------------
# The pod hop across processes
# ---------------------------------------------------------------------------


hop_stats = {"backend": None, "gathers": 0, "bytes_sent": 0,
             "bytes_received": 0}


def reset_hop_stats():
    hop_stats.update(backend=None, gathers=0, bytes_sent=0,
                     bytes_received=0)


def gather_rows(t: torch.Tensor, group, count: bool = True) -> torch.Tensor:
    """This process's (1, ...) row gathered over ``group``: (P, ...) in
    rank order, on ``t``'s device.  bf16 travels as its bytes (a bitcast,
    as the reference's u16; neither gloo nor NCCL carries int16).  A
    CUDA row goes to the backend as it is: gloo stages it through host
    memory itself (checked on the card, ``chip_smoke.py`` phase 50).
    ``count``: add the gather to ``hop_stats``."""
    import torch.distributed as dist

    pods = dist.get_world_size(group)
    wire = (t.view(torch.uint8) if t.dtype == torch.bfloat16
            else t).contiguous()
    parts = [torch.empty_like(wire) for _ in range(pods)]
    dist.all_gather(parts, wire, group=group)
    nbytes = wire.numel() * wire.element_size()
    if count:
        hop_stats.update(backend=dist.get_backend(group),
                         gathers=hop_stats["gathers"] + 1,
                         bytes_sent=hop_stats["bytes_sent"] + nbytes,
                         bytes_received=hop_stats["bytes_received"]
                         + nbytes * pods)
    out = torch.cat(parts, 0)
    return out.view(torch.bfloat16) if t.dtype == torch.bfloat16 else out


# ---------------------------------------------------------------------------
# The sync
# ---------------------------------------------------------------------------


def cross_pod_sync(grads, err: torch.Tensor, cfg: GradCompressConfig, *,
                   step: int = 0, uniforms=None, group=None):
    """Pod mean of pod-stacked gradients through packed N:M payloads.

    ``grads``: a master-structured tree of (rows, *shape) leaves, each
    row a pod's own gradient: all P pods on one card, or (``group``, a
    ``torch.distributed`` group of one process per pod) this process's
    pod alone; ``err``: the (rows, width) fp32 residual, updated in place
    (topk; mvue keeps it as it is).  ``step`` seeds mvue's draws
    (``mvue_uniforms``) unless ``uniforms`` (rows, width/m) gives them.
    Returns (the master-shaped mean gradients, each in its leaf's dtype;
    ``err``).  Each unit of the plan goes through one compress
    (``ops.grad_compress`` or ``mvue_compress``) and one
    ``ops.grad_decompress_mean`` call; ragged leaves take the fp32 mean
    over the pods, summed in pod order.  CUDA tensors launch the kernels,
    CPU tensors run the plain versions.
    """
    leaves = sgd.tree_leaves(grads)
    rows = leaves[0].shape[0]
    if group is None:
        pods, first = rows, 0
    else:
        import torch.distributed as dist

        pods, first = dist.get_world_size(group), dist.get_rank(group)
        if rows != 1:
            raise ValueError(f"a process holds one pod's row, not {rows}")
    plan = plan_for(grads, cfg.bucket_elems, cfg.m, stacked=True)
    if tuple(err.shape) != (rows, plan.width) or err.dtype != torch.float32:
        raise ValueError(
            f"EF residual {tuple(err.shape)} {err.dtype} != ({rows}, "
            f"{plan.width}) float32: init it against the same master tree")
    for x in leaves:
        if x.shape[0] != rows or x.device != err.device:
            raise ValueError(
                f"gradient leaf {tuple(x.shape)} on {x.device} is not "
                f"stacked over {rows} pods on {err.device}")
    n, m = cfg.n, cfg.m
    if cfg.estimator == "mvue" and uniforms is None:
        uniforms = torch.stack([mvue_uniforms(plan, step, first + r,
                                              err.device)
                                for r in range(rows)])
    outs = []
    for x, off in zip(leaves, plan.offsets):
        if off is None:   # dense fp32 pod mean, as the reference's pmean
            xs = x if group is None else gather_rows(x, group)
            acc = xs[0].to(torch.float32)
            for p in range(1, pods):
                acc = acc + xs[p].to(torch.float32)
            outs.append((acc / pods).to(x.dtype))
        else:
            outs.append(torch.empty(x.shape[1:], dtype=x.dtype,
                                    device=x.device))
    for members, col, numel in plan.units:
        g = (leaves[members[0]].reshape(rows, numel) if len(members) == 1
             else torch.cat([leaves[k].reshape(rows, -1) for k in members],
                            1))
        if cfg.estimator == "mvue":
            vals, idx = mvue_compress(g, n, m, uniforms[
                :, col // m:(col + numel) // m])
        else:
            vals, idx, _ = ops.grad_compress(g, err[:, col:col + numel], n,
                                             m)
        del g
        if group is not None:
            vals, idx = gather_rows(vals, group), gather_rows(idx, group)
        if len(members) == 1:
            ops.grad_decompress_mean(vals, idx, n, m,
                                     outs[members[0]].view(-1))
        else:
            flat = torch.empty(numel, dtype=outs[members[0]].dtype,
                               device=err.device)
            ops.grad_decompress_mean(vals, idx, n, m, flat)
            for j, k in enumerate(members):
                outs[k].view(-1).copy_(flat.view(len(members), -1)[j])
        del vals, idx   # one unit's payload alive at a time
    it = iter(outs)
    return sgd.tree_map(lambda _, x: next(it), grads), err


def wire_bytes(total: int, ragged: int, cfg: GradCompressConfig) -> int:
    """Per-pod bytes the process-group hop gathers per step: the packed
    payload (bf16 vals + uint8 idx, n per m-group of the ``total``
    compressible elements) plus the dense fp32 ``ragged`` elements."""
    groups = total // cfg.m
    return groups * cfg.n * (2 + 1) + ragged * 4
