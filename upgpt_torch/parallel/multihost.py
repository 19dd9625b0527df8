"""Joining the processes of a data-parallel run, and rank-0 gating.

Port of `upgpt_tpu.parallel.multihost`. The reference scales past one card
with Lightning DDP over NCCL (`Trainer(num_nodes=...)`, main.py:581): every
process runs the same script and the collectives join them. Here that is
one `torch.distributed` process group: every process runs `cli train
--multihost` (torchrun's environment or explicit arguments name the
group), trains on its own rows of each global batch, and exchanges
gradients through DDP. Checkpoints, metrics, TensorBoard, wandb and image
grids are written by rank 0 alone (`is_primary`).

The backend is chosen before the group starts, and printed on stderr:
NCCL where every local rank has a card of its own, gloo on the CPU and
where local ranks share a card (NCCL refuses two ranks on one device).
Gloo stages CUDA tensors through the host. There is no fallback from one
backend to the other: a group that fails to start, or a collective that
fails, raises. The group has a finite timeout, so a rank that dies leaves
the others blocked no longer than that, and it is torn down at exit.

A process with no cluster environment (no RANK / WORLD_SIZE) and no
explicit arguments joins nothing, as JAX's `initialize` is a no-op on one
host: `process_index()` is 0, `process_count()` 1, and `--multihost`
trains as one process.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import sys
from typing import Optional

import torch

# the group's timeout: a collective that waits longer raises (NCCL's
# watchdog aborts the communicator)
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Group:
    """The process group this process joined."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    backend: str
    device: torch.device


_GROUP: Optional[Group] = None


def choose_backend(device_type: str, local_world_size: int,
                   cards: int) -> str:
    """'nccl' where every local rank has a card of its own, else 'gloo'
    (the CPU, or local ranks sharing a card)."""
    if device_type == "cuda" and local_world_size <= cards:
        return "nccl"
    return "gloo"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def initialize(rank: Optional[int] = None,
               world_size: Optional[int] = None,
               local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None,
               master_addr: Optional[str] = None,
               master_port: Optional[int] = None,
               device: str = "cuda",
               timeout_s: Optional[float] = None) -> Optional[Group]:
    """Join this process to the run's process group (idempotent) and make
    its card the current device; returns the group, or None where there
    is no cluster to join.

    Arguments left None come from torchrun's environment: RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE (else WORLD_SIZE: one host),
    MASTER_ADDR (else 127.0.0.1) and MASTER_PORT. `device` "cuda" puts
    the rank on cuda:LOCAL_RANK, or, where the host's local ranks outnumber
    its cards, on card LOCAL_RANK modulo their count over gloo; "cpu"
    keeps it on the CPU over gloo. Without a card "cuda" raises.
    `timeout_s` (default `DEFAULT_TIMEOUT_S`) bounds every collective."""
    global _GROUP
    if _GROUP is not None:
        return _GROUP
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None and world_size is None:
        return None  # one process, nothing to join
    if rank is None or world_size is None:
        raise ValueError("a process group needs both a rank and a world "
                         "size (RANK and WORLD_SIZE)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    local_rank = (_env_int("LOCAL_RANK") if local_rank is None
                  else local_rank)
    local_rank = rank if local_rank is None else local_rank
    local_world_size = (_env_int("LOCAL_WORLD_SIZE")
                        if local_world_size is None else local_world_size)
    local_world_size = (world_size if local_world_size is None
                        else local_world_size)
    master_addr = master_addr or os.environ.get("MASTER_ADDR", "127.0.0.1")
    master_port = (_env_int("MASTER_PORT") if master_port is None
                   else master_port)
    if master_port is None:
        raise ValueError("a process group needs MASTER_PORT")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost: device 'cuda' asked for and no "
                               "CUDA device is visible; pass device='cpu' "
                               "for a CPU group")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        # before the first CUDA touch: the zoo's default "cuda", the
        # trainer's copy stream and the kernels' launches all resolve to
        # the current device
        torch.cuda.set_device(dev)
    elif device == "cpu":
        cards, dev = 0, torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    backend = choose_backend(dev.type, local_world_size, cards)
    why = {"nccl": f"one card per local rank ({local_world_size} local "
                   f"ranks, {cards} cards)",
           "gloo": ("the CPU" if dev.type == "cpu" else
                    f"{local_world_size} local ranks share {cards} "
                    f"card(s); NCCL takes one rank per card")}[backend]
    print(f"multihost: rank {rank}/{world_size} (local {local_rank}/"
          f"{local_world_size}) on {dev}, backend {backend} ({why}), "
          f"master {master_addr}:{master_port}", file=sys.stderr,
          flush=True)
    import torch.distributed as dist

    kwargs = {}
    if backend == "nccl":
        # binds the communicator to this rank's card
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{master_addr}:{master_port}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(
            seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s),
        **kwargs)
    _GROUP = Group(rank, world_size, local_rank, local_world_size, backend,
                   dev)
    atexit.register(shutdown)
    return _GROUP


def shutdown() -> None:
    """Tear the process group down (idempotent; registered at exit)."""
    global _GROUP
    if _GROUP is None:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None


def group() -> Optional[Group]:
    """The group this process joined, or None."""
    return _GROUP


def process_index() -> int:
    return 0 if _GROUP is None else _GROUP.rank


def process_count() -> int:
    return 1 if _GROUP is None else _GROUP.world_size


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and images."""
    return process_index() == 0


def device() -> Optional[torch.device]:
    """This rank's device, or None outside a group."""
    return None if _GROUP is None else _GROUP.device


def barrier(name: str = "upgpt_barrier") -> None:
    """Block until every process of the group reaches this point (no-op
    outside a group). `name` labels the wait in a hang's traceback."""
    if _GROUP is None:
        return
    import torch.distributed as dist

    kwargs = ({"device_ids": [_GROUP.device.index]}
              if _GROUP.backend == "nccl" else {})
    dist.barrier(**kwargs)
