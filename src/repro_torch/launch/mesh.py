"""Mesh construction on ``torch.distributed`` (the port's copy of
``repro.launch.mesh``).

Sharded execution is multi-controller: one process a rank, started by
``torchrun`` (``torchrun --nproc-per-node N -m repro_torch.launch.train
--mesh ...``), each holding its shard of every DTensor. A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the world's ranks,
with the reference's axis names. Every rank builds every mesh and submesh,
in the same order: group creation is collective.

The builders are functions, not module constants, so importing this module
touches no process group. :func:`init_distributed` starts the group from
``torchrun``'s environment; a run without that environment is a world of
one and needs no group unless it builds a mesh (the caller then passes a
rendezvous, e.g. ``file://`` in a temp dir).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.partition import mesh_context

__all__ = [
    "disagg_submeshes",
    "group_over",
    "init_distributed",
    "launcher_mesh",
    "make_fleet_mesh",
    "make_host_mesh",
    "make_production_mesh",
    "mesh_context",
    "mesh_ranks",
    "on_this_rank",
    "replica_meshes",
    "world_size",
]


def world_size() -> int:
    """Ranks in this run: the process group's size once it exists, else
    ``torchrun``'s ``WORLD_SIZE`` (1 without it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def mesh_ranks(mesh) -> tuple:
    """The global ranks a ``DeviceMesh`` spans, ascending (``()`` for
    None)."""
    if mesh is None:
        return ()
    return tuple(sorted(int(r) for r in mesh.mesh.flatten().tolist()))


def on_this_rank(mesh) -> bool:
    """Whether this process holds a shard of ``mesh`` (always, for None):
    a rank outside a mesh builds what lives there, for the host
    bookkeeping every rank shares, but runs none of its device work."""
    return mesh is None or mesh.get_coordinate() is not None


_GROUPS: dict = {"world": None}


def group_over(ranks: Sequence[int]):
    """A process group over ``ranks`` (global ranks): None, the default
    group, when they are the whole world; otherwise a group made once per
    rank set and process group, by its members only
    (``use_local_synchronization``), so disjoint rank sets can make theirs
    concurrently. Every member must ask for it in the same order."""
    ranks = tuple(sorted(int(r) for r in ranks))
    if ranks == tuple(range(dist.get_world_size())):
        return None
    if _GROUPS["world"] is not dist.group.WORLD:  # a new process group: the old groups are gone
        _GROUPS.clear()
        _GROUPS["world"] = dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks), use_local_synchronization=True)
    return _GROUPS[ranks]


def init_distributed(device, init_method: Optional[str] = None) -> int:
    """Start the default process group: NCCL for CUDA, gloo for the CPU.
    Under ``torchrun`` (``WORLD_SIZE`` set) the group comes from its
    environment and each rank takes the card ``LOCAL_RANK``; otherwise
    ``init_method`` (a ``file://`` or ``tcp://`` rendezvous) makes a world
    of one, and without it no group is made. Returns the world size."""
    device = torch.device(device)
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if device.type == "cuda" else "gloo"
    torchrun = "WORLD_SIZE" in os.environ
    if device.type == "cuda" and (torchrun or init_method is not None):
        # the card before the group, so that NCCL's communicator binds it
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) if torchrun else (device.index or 0))
    if torchrun:
        dist.init_process_group(backend, init_method=init_method or "env://")
    elif init_method is not None:
        dist.init_process_group(backend, init_method=init_method, world_size=1, rank=0)
    return world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16×16 (``("data", "model")``, 256 ranks) or 2×16×16 (``("pod",
    "data", "model")``, 512 ranks; the leading ``pod`` axis carries
    data-parallel replication across the slow boundary). Raises
    ``SystemExit`` naming the world it needs, before any allocation, when
    the run's world differs."""
    _require_world(multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _require_world(multi_pod: bool) -> None:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    need = 512 if multi_pod else 256
    have = world_size()
    if have != need:
        raise SystemExit(
            f"the {'multipod' if multi_pod else 'production'} mesh {shape} needs a world of {need} ranks "
            f"(torchrun --nnodes ... --nproc-per-node ...), this run has {have}"
        )


def launcher_mesh(name: str, device) -> Optional[DeviceMesh]:
    """The mesh a launcher's ``--mesh`` names: None for ``host`` (the
    meshless single-device path, kept as it was), else the production or
    multipod mesh over this ``torchrun`` world. The world size is checked
    first, before any process group or allocation."""
    if name == "host":
        return None
    multi_pod = name == "multipod"
    _require_world(multi_pod)
    init_distributed(device)
    return make_production_mesh(multi_pod=multi_pod, device_type=torch.device(device).type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A 1×1 ``("data", "model")`` mesh over this rank's device (tests,
    examples); needs a process group (:func:`init_distributed`)."""
    return DeviceMesh(device_type, torch.tensor([[dist.get_rank()]]), mesh_dim_names=("data", "model"))


def make_fleet_mesh(replicas: int, *, devices: Optional[Sequence[int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """The serving-fleet mesh: ``("replica", "data", "model")`` with the
    leading axis indexing engine replicas (each replica tensor-parallels its
    engine over its ``model`` slice; ``data`` is kept for API symmetry with
    the training meshes and is 1 in serving) over ``devices`` (ranks; all
    of the world's by default). Replicas must divide the rank count — a
    ragged fleet would strand devices silently."""
    ranks = list(range(world_size())) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if n % replicas:
        raise ValueError(
            f"{replicas} replicas do not divide {n} devices: every replica "
            "gets an identical mesh slice (identical programs), so a ragged "
            f"split would strand devices. Pick a replica count that divides {n}."
        )
    grid = torch.tensor(ranks).reshape(replicas, 1, n // replicas)
    return DeviceMesh(device_type, grid, mesh_dim_names=("replica", "data", "model"))


def replica_meshes(fleet_mesh: DeviceMesh):
    """One ``("data", "model")`` submesh per replica — what each
    :class:`~repro_torch.serve.engine.ServeEngine` shards itself over, built
    from the fleet mesh's rank tensor. Submeshes are disjoint by
    construction: replica i's engine CANNOT address replica j's devices.
    Every rank builds all of them, in order (group creation is
    collective)."""
    grid = fleet_mesh.mesh
    return [DeviceMesh(fleet_mesh.device_type, grid[i], mesh_dim_names=("data", "model")) for i in range(grid.shape[0])]


def disagg_submeshes(mesh: DeviceMesh):
    """Split one replica's ``("data", "model")`` mesh into a (prefill,
    decode) pair of disjoint halves along the model axis. A single-device
    replica colocates: both halves are the same mesh."""
    grid = mesh.mesh
    m = grid.shape[-1]
    if m < 2:
        return mesh, mesh
    half = m // 2
    names = mesh.mesh_dim_names
    prefill = DeviceMesh(mesh.device_type, grid[..., :half], mesh_dim_names=names)
    decode = DeviceMesh(mesh.device_type, grid[..., half:], mesh_dim_names=names)
    return prefill, decode
