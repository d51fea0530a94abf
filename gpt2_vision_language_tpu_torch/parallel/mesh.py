"""The process mesh: ranks of a ``torch.distributed`` world laid out on named
axes, with a process group for each axis.

Counterpart of gpt2_vision_language_tpu/parallel/mesh.py. The JAX package is
one SPMD program over a device mesh; here every device is a process (one
rank), launched by ``python -m torch.distributed.run``, which sets the
variables ``maybe_init_distributed`` reads. ``make_mesh`` keeps the JAX
signature with ranks for devices: the ranks fill the mesh's shape in row
order, so with axes ("data", "model") the ranks of one model group are
consecutive and those of one data group are ``tp`` apart; the pipeline's
meshes are ("data", "pipe") and ("data", "pipe", "model"), as the JAX
trainer lays them out (train/pretrain.py:74-87 there). Every rank builds the
group of every set of axes (``dist.new_group`` is collective) and keeps its
own.

Rank -> card: ``device_for_rank("cuda")`` maps local rank i to ``cuda:i`` and
raises when the node has fewer cards than local ranks; an explicit
``cuda:N`` puts every rank on that one card (several processes sharing it);
the CPU only by ``cpu``. The backend follows one rule (``choose_backend``):
NCCL when every rank has a card of its own, gloo when ranks share a card or
run on the CPU. Nothing retries on another backend after a failure.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.ring_attention import GroupRing


def local_world() -> int:
    """Processes on this node (LOCAL_WORLD_SIZE of the launcher; 1 alone)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def device_for_rank(device) -> torch.device:
    """This rank's device from the ``--device`` value: "cuda" -> cuda:LOCAL_RANK
    (one card a rank), "cuda:N" -> that card for every rank, "cpu" -> the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = local_world()
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"--device cuda maps each of the {n} local ranks to a card of its own, but the "
            f"node has {have}; pass --device cuda:0 to put every rank on one card")
    return torch.device("cuda", local_rank())


def choose_backend(device) -> str:
    """The backend for ranks placed by ``device_for_rank(device)``: NCCL when
    every rank has a card of its own ("cuda", or one rank a node on "cuda:N"),
    gloo when the ranks of a node share one card ("cuda:N") or run on the
    CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    shared = dev.index is not None and local_world() > 1
    return "gloo" if shared else "nccl"


def maybe_init_distributed(backend: str | None = None) -> None:
    """Join the process group that MASTER_ADDR, MASTER_PORT, RANK and
    WORLD_SIZE describe; a no-op for a single process without them or when
    the group is already joined."""
    if dist.is_available() and not dist.is_initialized() and os.environ.get("MASTER_ADDR"):
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        )


def init_distributed(device) -> torch.device:
    """This rank's device (``device_for_rank``), after joining the launcher's
    process group with the backend of ``choose_backend``, printed once. A
    single process without the launcher's variables joins nothing."""
    dev = device_for_rank(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized() or not os.environ.get("MASTER_ADDR"):
        return dev
    backend = choose_backend(device)
    maybe_init_distributed(backend)
    if dist.get_rank() == 0:
        print(f"[dist] world {dist.get_world_size()}, backend {backend}, rank 0 on {dev}")
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_master() -> bool:
    """Rank 0 does the I/O; a single process is its own master."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class Mesh:
    """Ranks on named axes: ``size(axis)``, this rank's ``coord(axis)`` and
    the process ``group(axes)`` of the ranks that differ from it on those
    axes alone (one axis name or a tuple of them; None when they hold one
    rank); ``world_group`` holds every rank. An axis the mesh does not name
    has size 1. Every rank builds the group of every set of axes whose size
    is above 1 and below the world's (``dist.new_group`` is collective)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]):
        self.axis_names, self.shape = tuple(axis_names), tuple(int(s) for s in shape)
        self.world = 1
        for s in self.shape:
            self.world *= s
        joined = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if joined else 0
        self._groups = {}
        self.world_group = dist.group.WORLD if joined else None
        rest = self.rank
        self._coords = {}
        for name, s in reversed(list(zip(self.axis_names, self.shape))):
            self._coords[name] = rest % s
            rest //= s
        if not joined:
            return
        wide = [i for i, s in enumerate(self.shape) if s > 1]
        for n in range(1, len(wide)):
            for axes in itertools.combinations(wide, n):
                for ranks in self._axis_ranks(axes):
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g
        if wide:
            self._groups[tuple(wide)] = self.world_group

    def _axis_ranks(self, axes):
        """Every group of the ranks that differ only along ``axes`` (indices),
        each in row order."""
        strides = [1] * len(self.shape)
        for i in range(len(self.shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * self.shape[i + 1]
        groups = {}
        for r in range(self.world):
            base = r - sum(((r // strides[a]) % self.shape[a]) * strides[a] for a in axes)
            groups.setdefault(base, []).append(r)
        return list(groups.values())

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def coord(self, axis: str) -> int:
        return self._coords.get(axis, 0)

    def group(self, axes):
        """The group over ``axes`` (a name or a tuple of names); axes of size 1
        and axes the mesh does not name are dropped."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(i for i, a in enumerate(self.axis_names) if a in names and self.shape[i] > 1)
        return self._groups.get(key)

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names, self.shape))
        return f"Mesh({axes}; rank {self.rank})"


def make_mesh(num_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """The JAX ``make_mesh`` over ranks: ``num_devices`` must be the world's
    size when given; ``shape`` defaults to every rank on the first axis."""
    n = world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"{num_devices} devices asked for, but the world has {n} "
                         "processes (launch one process a device with "
                         "python -m torch.distributed.run --nproc_per_node N)")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    prod = 1
    for s in shape:
        prod *= int(s)
    if prod != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} processes")
    return Mesh(axis_names, shape)


def ring_from_group(group=None) -> GroupRing:
    """The ring handle over a process group (the default group when None):
    this process holds one chunk of the sequence and K/V travel rank to rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("ring_from_group needs an initialized torch.distributed "
                           "process group (maybe_init_distributed, or init_process_group)")
    return GroupRing(group)
