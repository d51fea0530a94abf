"""Process-group set-up for the ring of ring attention.

Counterpart of the part of gpt2_vision_language_tpu/parallel/mesh.py that the
ring needs (``maybe_init_distributed`` :32, ``is_master`` :38). The JAX package
is one SPMD program over a device mesh and rings over the mesh's "model" axis;
here a ring is either run in turn by one process
(``ops.ring_attention.LocalRing``) or spread over the ranks of a
``torch.distributed`` process group, one chunk of the sequence each
(``ring_from_group``). Nothing on a machine tells a program of a cluster:
``maybe_init_distributed`` reads the torchrun variables and does nothing
without them.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from ..ops.ring_attention import GroupRing


def maybe_init_distributed(backend: str | None = None) -> None:
    """Join the process group that MASTER_ADDR, MASTER_PORT, RANK and
    WORLD_SIZE describe; a no-op for a single process without them. The
    backend defaults to torch.distributed's choice for the devices present."""
    if dist.is_available() and not dist.is_initialized() and os.environ.get("MASTER_ADDR"):
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        )


def is_master() -> bool:
    """Rank 0 does the I/O; a single process is its own master."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def ring_from_group(group=None) -> GroupRing:
    """The ring handle over a process group (the default group when None):
    this process holds one chunk of the sequence and K/V travel rank to rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("ring_from_group needs an initialized torch.distributed "
                           "process group (maybe_init_distributed, or init_process_group)")
    return GroupRing(group)
