"""The mesh: named axes over the ranks of a process group.

Counterpart of ``src/repro/launch/mesh.py`` (``make_host_mesh``,
``mesh_chips``).  The reference's mesh is an array of devices that one
SPMD program runs over; the port's is an array of processes, one rank a
cell, in row-major order over the axes (the rank of (pod p, data d,
model k) is (p * D + d) * K + k, as ``numpy.reshape`` lays the
reference's devices out).  Each rank knows its coordinate and holds one
``torch.distributed`` group an axis: the ranks that share every other
coordinate, in the order of their coordinate on that axis (the "pod"
group of rank (p, d) is the P ranks (0..P-1, d)), built with
``dist.new_group`` on every rank in one fixed order.  Where the
data-parallel axes ("pod" and "data") have more than one rank between
them, the mesh also holds their joint group under the key ``DP_AXES``:
the ranks that share the rank's "model" coordinate, in the order of
their DP index pod * D + data, the reference's row-major device order
along ("pod", "data").  A mesh of one rank has no groups and needs no
process group.

``torch.distributed.device_mesh`` is not used: its CUDA meshes ask for
NCCL sub-groups, and NCCL refuses two ranks on one card, which is how
the ranks of a mesh share one card here (``launch.dist``).  The groups
take the backend of the default group (gloo there).

What differs: ``make_production_mesh`` and the reference's hardware
constants are a TPU pod's and have no counterpart.
"""

from __future__ import annotations

import dataclasses
import math

# the data-parallel axes, outer first: a rank's DP index is row-major
# over them, and the batch's rows (the serving slots) are cut over them
DP_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: ordered {axis: size}; ``rank``: this process's rank,
    row-major over the axes; ``groups``: {axis: process group} for every
    axis of size > 1, and {DP_AXES: group} where the DP axes have more
    than one rank (empty for a mesh that only plans)."""
    shape: dict
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> dict:
        """{axis: this rank's coordinate on it}."""
        out, rest = {}, self.rank
        for axis in reversed(self.axis_names):
            out[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        return {a: out[a] for a in self.axis_names}

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis`` (None when it has one rank)."""
        return self.groups.get(axis)

    @property
    def dp_size(self) -> int:
        """D: the ranks over the DP axes."""
        return math.prod(self.shape.get(a, 1) for a in DP_AXES)

    @property
    def dp_index(self) -> int:
        """This rank's DP index, pod * D_data + data."""
        return self.coord("pod") * self.shape.get("data", 1) + \
            self.coord("data")

    def dp_group(self):
        """The process group over the DP axes; None when D = 1 or the
        mesh only plans."""
        return self.groups.get(DP_AXES)


def rank_of(shape: dict, coords: dict) -> int:
    """The rank of the cell at ``coords`` of a mesh of ``shape``."""
    rank = 0
    for axis, size in shape.items():
        rank = rank * size + coords.get(axis, 0)
    return rank


def _unflatten(shape: dict, axes: list, flat: int) -> dict:
    coords = {}
    for a in reversed(axes):
        coords[a] = flat % shape[a]
        flat //= shape[a]
    return coords


def axis_ranks(shape: dict, axis) -> list:
    """Every group of ``axis`` (a name, or a tuple of names such as
    ``DP_AXES``): the ranks that share every other coordinate, each in
    row-major order of its coordinates on ``axis``; the groups in
    row-major order of the other coordinates."""
    axes = {axis} if isinstance(axis, str) else set(axis)
    inner = [a for a in shape if a in axes]
    others = [a for a in shape if a not in axes]
    count = math.prod(shape[a] for a in inner)
    return [[rank_of(shape, {**_unflatten(shape, others, flat),
                             **_unflatten(shape, inner, i)})
             for i in range(count)]
            for flat in range(math.prod(shape[a] for a in others))]


def build_groups(shape: dict, rank: int) -> dict:
    """{axis: this rank's group} over the default process group, for
    every axis of size > 1, and {DP_AXES: its DP group} where the DP
    axes have more than one rank; every rank makes every group, in one
    order, as ``dist.new_group`` wants."""
    import torch.distributed as dist

    if math.prod(shape.values()) != dist.get_world_size():
        raise ValueError(f"mesh {dict(shape)} covers "
                         f"{math.prod(shape.values())} ranks, the process "
                         f"group has {dist.get_world_size()}")
    groups = {}
    axes = [a for a, size in shape.items() if size > 1]
    if math.prod(shape.get(a, 1) for a in DP_AXES) > 1:
        axes.append(DP_AXES)
    for axis in axes:
        for ranks in axis_ranks(shape, axis):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return groups


def make_host_mesh(*, model: int = 1, pods: int = 1, world=None,
                   rank=None) -> Mesh:
    """The mesh of every rank of the process group (one rank when there
    is none): ("pod", "data", "model") with ``pods`` > 1, else ("data",
    "model"); ``model`` and ``pods`` fall back to 1 when they do not
    divide the ranks, as in the reference."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    n = world if world is not None else (dist.get_world_size() if live
                                         else 1)
    if n % (model * pods):
        model = pods = 1
    shape = ({"pod": pods, "data": n // (model * pods), "model": model}
             if pods > 1 else {"data": n // model, "model": model})
    return mesh_over_group(shape, rank)


def mesh_over_group(shape: dict, rank=None) -> Mesh:
    """A ``Mesh`` of ``shape`` over the default process group, this
    process at ``rank`` (its rank there), its axis groups built; a
    one-rank mesh needs no group."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if math.prod(shape.values()) == 1:
        return Mesh(dict(shape))
    if not live:
        raise RuntimeError(f"mesh {dict(shape)} spans several ranks: "
                           "start the processes with torchrun (or join a "
                           "process group) first")
    rank = dist.get_rank() if rank is None else rank
    return Mesh(dict(shape), rank, build_groups(shape, rank))


def mesh_chips(mesh) -> int:
    """Cells of the mesh: ranks here, chips in the reference."""
    return math.prod(mesh.shape.values())
