"""Process-group mesh helpers (counterpart of enoki_tpu/dist/mesh.py).

The reference builds a 2-D JAX ``Mesh`` ('dp', 'sp') over every device of
one controller and lets GSPMD place the collectives. PyTorch has no such
compiler: the port runs one process per GPU (``torchrun``, ``nccl``; on
the CPU one process per "device" over ``gloo``) and shards by hand over a
``torch.distributed.device_mesh.DeviceMesh`` of ranks. 'dp' shards image
rows, 'sp' image columns; the scene's parameters are replicated and their
gradients reduced over both axes, by the caller (``dist.render``).

``torch.distributed.tensor`` places the image and the target
(``image_sharding``: ``[Shard(0), Shard(1)]``); the render itself runs on
each rank's local tile, as plain tensors.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .._device import resolve_device

# the cluster variables of torchrun and SLURM that mean "a world was meant"
CLUSTER_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "SLURM_JOB_ID")

# the process group over all ranks of a mesh smaller than the world, by
# its ranks; every rank makes it in make_mesh (new_group is collective)
_GROUPS: dict = {}


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square factorization n = a*b, a >= b."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "sp"), device=None):
    """A 2-D ``DeviceMesh`` over the first ``n_devices`` ranks of the
    world (default: all), in the most-square shape (a, b), a >= b. The
    inner axis runs over consecutive ranks, which ``torchrun`` places on
    one node. Ranks outside the mesh get no coordinate
    (``get_coordinate()`` is None) and sit out of its collectives.

    Collective: every rank of the world calls it. ``device`` is the
    device the ranks work on (None: the card, or raise; "cpu" for the
    ``gloo`` worlds of the CPU). ``ValueError`` without a process group,
    for fewer than one rank or more than the world holds."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs a process group: call "
                         "init_distributed (or init_process_group) first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh needs 1 to {world} ranks (the world "
                         f"size), got {n_devices}")
    from torch.distributed.device_mesh import DeviceMesh

    a, b = _factor2(n)
    ranks = torch.arange(n).reshape(a, b)
    mesh = DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=tuple(axis_names))
    if n < world:
        key = tuple(range(n))
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(list(key))
    return mesh


def mesh_group(mesh):
    """The process group of every rank of ``mesh``: the world's where the
    mesh covers it, else the one make_mesh made."""
    ranks = tuple(mesh.mesh.flatten().tolist())
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return _GROUPS[ranks]


def image_sharding(mesh):
    """(n, n) image: rows over dp, cols over sp (``P("dp", "sp")``)."""
    from torch.distributed.tensor import Shard

    return (Shard(0), Shard(1))


def replicated(mesh):
    """Every rank holds all of it (``P()``)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def _cluster_world(coordinator_address, num_processes, process_id):
    """(address, world size, rank) from the arguments, else torchrun's or
    SLURM's variables; ValueError where one is missing."""
    env = os.environ
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = num_processes
    if world is None:
        world = env.get("WORLD_SIZE", env.get("SLURM_NTASKS"))
    rank = process_id
    if rank is None:
        rank = env.get("RANK", env.get("SLURM_PROCID"))
    missing = [name for name, v in (("the coordinator address", addr),
                                    ("the number of processes", world),
                                    ("the process id", rank)) if v is None]
    if missing:
        raise ValueError(f"init_distributed: a cluster is meant (arguments "
                         f"or {', '.join(CLUSTER_VARS)}) but "
                         f"{' and '.join(missing)} cannot be found")
    return addr, int(world), int(rank)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> int:
    """Start this process's part of the world; returns the world size.

    One call a process, before ``make_mesh``. The backend is ``nccl`` for
    the card (``device`` None: the card, or raise) and ``gloo`` for
    ``device="cpu"``; on the card the process takes GPU ``LOCAL_RANK``
    (``SLURM_LOCALID``). ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` override torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` (and
    SLURM's ``SLURM_NTASKS``, ``SLURM_PROCID``).

    Arguments or a cluster environment that fail to initialise raise: a
    silent world of one would train N replicas or hang at the first
    collective. With neither, it warns and makes a world of one (an
    in-process store, nothing on the network). Already initialised: the
    world as it is."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    cluster = any(k in os.environ for k in CLUSTER_VARS)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID",
                                                            "0"))
        torch.cuda.set_device(int(local))
    if explicit or cluster:
        addr, world, rank = _cluster_world(coordinator_address,
                                           num_processes, process_id)
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                world_size=world, rank=rank)
    else:
        warnings.warn("init_distributed: no cluster found (no arguments, "
                      f"none of {', '.join(CLUSTER_VARS)}): a world of one "
                      "process")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    return dist.get_world_size()
