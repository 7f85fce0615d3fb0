"""A process group from the environment, and the rank -> device map.

No reference counterpart (the reference runs one SPMD program over a
mesh).  The port runs one process a rank: ``torchrun --nproc-per-node W
-m repro_torch.launch.train ...`` (or ``python -m
torch.distributed.run``) sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, and ``init_from_env`` joins that
group.  The ranks form a ``launch.mesh.Mesh`` (``--mesh``, or "pod=W"
without it: one pod a rank) whose axis groups (``dist.new_group``: the
"data" group of the ranks of one pod, the "pod" group of the ranks that
share a data coordinate) carry the FSDP gathers and reductions and the
pod hop, on the default group's backend.

Backends: NCCL when every rank has a card of its own, else gloo.  NCCL
refuses two ranks on one device, so P processes on one card run gloo,
which gathers CUDA tensors through host memory itself.  NCCL across
several cards is written but has not run: the machines this port is
checked on hold one card.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Pods:
    """This process's place among the pods: the group (None: every pod
    in one process), the pod count, this process's rank and device."""
    group: object
    world: int
    rank: int
    device: torch.device


def env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def pick_backend(device_type: str, world: int) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else
    gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``device`` when it names one ("cpu", "cuda:1"),
    else card ``local_rank`` modulo the cards present (ranks share a
    card when there are more ranks than cards)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass --device cpu to run the port's plain "
            "PyTorch path on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_from_env(device=None) -> Pods:
    """Join the process group the environment describes (``env://``) when
    ``WORLD_SIZE`` > 1; else one process, no group."""
    world = env_world()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = rank_device(device, local)
    if world <= 1:
        return Pods(None, 1, 0, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(pick_backend(dev.type, world),
                                init_method="env://")
    return Pods(dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                dev)


def shutdown(pods: Pods):
    if pods.group is not None and dist.is_initialized():
        dist.destroy_process_group()
