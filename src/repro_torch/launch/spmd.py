"""The ``--mesh`` grammar and the mesh it builds over the process group.

Counterpart of ``src/repro/launch/spmd.py`` (``parse_mesh_spec``,
``make_spmd_mesh``, ``single_device_mesh``), with the reference's
grammar:

    pod,data,model            axis names; the rank count auto-factored,
                              inner axes ("model") get factors first
    pod=2,data=2,model=2      explicit sizes (their product must divide
                              the rank count; unsized axes take the rest)

Serve-side resolution, as the reference's: ``_sanitize_pspec`` and
``sanitize_pspecs`` (a spec entry whose mesh axes do not divide its dim
is replicated; defined in ``sharding.rules``) and ``serve_shardings``
(the SERVE_BATCH specs of a continuous-batching engine: the weights TP
over "model" with N:M groups unsplit, the packed ``vals``/``idx`` on w's
spec, the slot-paged cache, the per-slot tokens and positions), resolved
over the port's meta trees (``transformer_lm.abstract_params`` and
``init_specs``).

What differs: the cells are the ranks of the process group
(``launch.mesh.Mesh``), not devices, so there is no
``force_host_devices``: ranks come from ``torchrun`` or ``mp.spawn``.
``serve_shardings`` returns the reference's ``"pspecs"`` trees
(``params``, ``cache``, ``token``, ``pos``) as the port's spec tuples:
there is no ``NamedSharding``; ``sharding.tp`` executes them
(``ServeEngine(mesh=)``).  The serving fleet's ``replica_device_groups``
partitions a device list as the reference's does; ``fleet_meshes``
gives each replica its group as one torch device
(``ServeFleet(devices=)``), and raises NotImplementedError for a group
of more than one device: a fleet replica over a process group needs
the fleet's router to run on every rank in lockstep (ROADMAP item 7.5;
one engine over such a group is ``ServeEngine(mesh=)``).
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh, mesh_over_group
from repro_torch.sharding import rules as R
# the reference defines these here; the port keeps them beside the
# rules, where ``sharding.tp`` reads them too
from repro_torch.sharding.rules import (  # noqa: F401
    _sanitize_pspec, sanitize_pspecs)


def parse_mesh_spec(spec: str, n_devices: int) -> dict:
    """``--mesh`` string -> ordered {axis: size} covering ``n_devices``
    ranks.  Prime factors of what the sized axes leave go to the
    innermost unsized axes first: 8 over "pod,data,model" is {pod: 2,
    data: 2, model: 2}, 4 is {pod: 1, data: 2, model: 2}."""
    axes: dict = {}
    unsized = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, size = part.split("=")
            axes[name.strip()] = int(size)
        else:
            axes[part] = None
            unsized.append(part)
    sized = 1
    for v in axes.values():
        sized *= v or 1
    if n_devices % sized:
        raise ValueError(f"mesh sizes {spec!r} (product {sized}) do not "
                         f"divide device count {n_devices}")
    rest = n_devices // sized
    for name in unsized:
        axes[name] = 1
    factors = []
    x, p = rest, 2
    while x > 1:
        while x % p == 0:
            factors.append(p)
            x //= p
        p += 1
    for i, f in enumerate(sorted(factors, reverse=True)):
        if not unsized:
            raise ValueError(f"{spec!r} under-covers {n_devices} devices "
                             f"({rest}x unassigned, no unsized axis)")
        axes[unsized[-1 - (i % len(unsized))]] *= f
    return axes


def make_spmd_mesh(spec: str = "pod,data,model", *, world=None,
                   rank=None) -> Mesh:
    """The mesh of a ``--mesh`` spec over the ranks of the process group
    (``world`` ranks, by default all of them; one when there is
    none), with this rank's axis groups."""
    import torch.distributed as dist

    if world is None:
        live = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if live else 1
    return mesh_over_group(parse_mesh_spec(spec, world), rank)


def single_device_mesh(axis_names=("data", "model")) -> Mesh:
    """A one-rank mesh with the same axis names: the parity reference."""
    return Mesh({a: 1 for a in axis_names})


def replica_device_groups(n_replicas: int, *, devices=None) -> list:
    """Partition ``devices`` (by default every CUDA device) into
    ``n_replicas`` disjoint contiguous groups: fleet replicas never
    share a group; lanes cross replicas through the host-side
    CacheStore, not a collective."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[...] to "
                               "partition other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if len(devices) % n_replicas:
        raise ValueError(f"{len(devices)} devices do not split into "
                         f"{n_replicas} equal replica groups")
    per = len(devices) // n_replicas
    return [devices[i * per:(i + 1) * per] for i in range(n_replicas)]


def fleet_meshes(n_replicas: int, *, devices=None) -> list:
    """Each fleet replica's device group as the one torch device it
    serves on, for ``ServeFleet(devices=)``.  One engine serves over a
    group of ranks (``ServeEngine(mesh=)``: its slots over the DP axes,
    the dense attention LMs' heads over "model"); a fleet replica over
    a device group needs the fleet's router to run on every rank of the
    group in lockstep: not ported (ROADMAP item 7.5)."""
    out = []
    for group in replica_device_groups(n_replicas, devices=devices):
        if len(group) > 1:
            raise NotImplementedError(
                f"a replica group of {len(group)} devices: one engine serves "
                "over a group of ranks (ServeEngine(mesh=), slot lanes over "
                "'pod'/'data', heads over 'model'), but a fleet replica over "
                "a device group needs the fleet's router on every rank in "
                "lockstep; not ported: ROADMAP item 7.5, a fleet replica "
                "over a device group")
        out.append(torch.device(group[0]))
    return out


# ---------------------------------------------------------------------------
# Serve-side spec resolution (SERVE_BATCH rules, slot-paged cache)
# ---------------------------------------------------------------------------


def serve_shardings(cfg, mesh, sp_cfg, *, n_slots: int, max_len: int,
                    packed: bool = False, idx_bits=None,
                    cache_dtype=torch.bfloat16) -> dict:
    """The SERVE_BATCH specs of a continuous-batching engine over
    ``mesh``: ``{"params", "cache", "token", "pos"}``.  ``params`` is
    the weights' spec tree (TP over "model", N:M groups unsplit; with
    ``packed`` the element-packed tree's, ``vals`` and ``idx`` on w's
    spec, ``idx_bits`` resolved as the engine's store resolves it),
    asserted group-safe (``rules.assert_nm_unsplit``); ``cache`` the
    slot-paged cache's (slots over the DP axes, KV heads over "model"
    where they divide), ``token`` and ``pos`` the per-slot inputs'."""
    from repro_torch.models import transformer_lm as T
    from repro_torch.serve.packed_params import pack_tree_element

    aparams = T.abstract_params(cfg)
    p_pspecs = R.nm_params_pspecs(T.init_specs(cfg), R.SERVE_BATCH_RULES,
                                  aparams, mesh, sp_cfg)
    check_tree = aparams
    if packed:
        check_tree, _, p_pspecs = pack_tree_element(
            aparams, sp_cfg, idx_bits, pspecs=p_pspecs, device="meta")
    R.assert_nm_unsplit(p_pspecs, check_tree, mesh, sp_cfg)

    cache = T.init_lm_cache(cfg, n_slots, max_len, device="meta",
                            dtype=cache_dtype)
    in_pspecs = R.serve_input_pspecs({"cache": cache, "token": None},
                                     mesh, long_context=False)
    # continuous batching: a per-slot position vector, not a cursor
    pos = (R.batch_entry(mesh),)
    return {"params": p_pspecs,
            "cache": sanitize_pspecs(in_pspecs["cache"], cache, mesh),
            "token": _sanitize_pspec(in_pspecs["token"], (n_slots, 1), mesh),
            "pos": _sanitize_pspec(pos, (n_slots,), mesh)}
