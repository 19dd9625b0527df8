"""A rank's rows of the global batch, and averages over the process group.

Port of `upgpt_tpu.parallel.mesh`. JAX's data parallelism is one `Mesh`
whose `data` axis shards the batch and replicates the parameters; `jit`
emits the gradient all-reduce. In the port each rank is a process with
its own model replica (`multihost`), so what is left of the mesh is:

- `host_local_slice` (JAX :104-116): the rows of the global batch a
  process loads. JAX checks the split with a bare `assert`, which
  `python -O` drops (the reference fault R16); here an uneven split
  raises `ValueError`.
- `local_rows`: this rank's rows of a global tree of tensors, the
  counterpart of `shard_batch` (:84-101), which assembles a global array
  from the local slices. Every rank draws the whole global batch's
  randomness and keeps its rows, as JAX's sharded `jit` draws it once
  over the global batch, so N ranks give one process's draws.
- `mean_over_group` and `mean_gradients_`: averages of scalar metrics
  and of gradients over the group (identities outside a group).

`create_mesh`, `create_hybrid_mesh`, `batch_sharding` and
`replicated_sharding` have no counterpart: they are GSPMD layouts of one
program over many devices, and the port runs one program per rank.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from upgpt_torch.parallel import multihost


def host_local_slice(global_batch: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> slice:
    """The rows of a global batch that process `process_index` of
    `process_count` (default: this process in its group) holds. Raises
    `ValueError` where the batch does not split evenly (JAX asserts, R16)."""
    pi = multihost.process_index() if process_index is None else process_index
    pc = multihost.process_count() if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} outside [0, {pc})")
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def local_rows(tree: Any, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Any:
    """This rank's rows (dim 0) of every tensor or array in a tree of
    dicts, lists and tuples; other leaves pass through. All leaves share
    the global batch size."""
    if process_count is None and multihost.process_count() == 1:
        return tree

    def rows(node):
        if isinstance(node, dict):
            return {k: rows(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rows(v) for v in node)
        if hasattr(node, "shape") and len(node.shape):
            return node[host_local_slice(node.shape[0], process_index,
                                         process_count)]
        return node

    return rows(tree)


def mean_over_group(values: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over the group in one all-reduce (identity
    outside a group). Every rank must call it, with the same keys."""
    if multihost.process_count() == 1 or not values:
        return values
    import torch.distributed as dist

    keys = sorted(values)
    stacked = torch.stack([values[k].detach().float().reshape(())
                           for k in keys])
    dist.all_reduce(stacked)
    stacked /= multihost.process_count()
    return dict(zip(keys, stacked.unbind()))


def mean_gradients_(tensors: List[torch.Tensor]) -> None:
    """Average tensors over the group in place (identity outside a group):
    one all-reduce per tensor, each divided by the world size first, as
    DDP's buckets are."""
    n = multihost.process_count()
    if n == 1:
        return
    import torch.distributed as dist

    for t in tensors:
        t.div_(n)
        dist.all_reduce(t)


def time_all_reduce(bucket_bytes: List[int], device: torch.device,
                    repeats: int = 3) -> Optional[float]:
    """Milliseconds to all-reduce float32 buffers of `bucket_bytes` one
    after another over the group, on `device`, the mean of `repeats`
    rounds after one untimed round: a step's gradient exchange timed
    alone, outside the step. A collective: every rank calls it with the
    same sizes. None outside a group or without buckets."""
    if multihost.group() is None or not bucket_bytes:
        return None
    import time

    import torch.distributed as dist

    bufs = [torch.zeros(n // 4, device=device) for n in bucket_bytes]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for b in bufs:  # untimed: first-use setup of the buffers' paths
        dist.all_reduce(b)
    sync()
    multihost.barrier("time_all_reduce")
    t0 = time.perf_counter()
    for _ in range(repeats):
        for b in bufs:
            dist.all_reduce(b)
    sync()
    return 1e3 * (time.perf_counter() - t0) / repeats
