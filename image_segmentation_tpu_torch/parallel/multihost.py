"""Data parallelism across processes: bring-up and the host-side contract.

Counterpart of image_segmentation_tpu/parallel/multihost.py. JAX runs one
GSPMD program over a global mesh, and each process feeds its own
devices' rows of the global batch. The port runs one process per device
over a `torch.distributed` group, and what this module keeps of JAX's is
the host-side contract around the step:

- `initialize_multihost(coordinator, num_processes, process_id)` (:50):
  the group, from `host:port` (a TCP store on process 0) or a `file://`
  store; idempotent. The backend follows the placement
  (`mesh.backend_for`): gloo on the CPU, NCCL when every process of a
  host has a card of its own, gloo when processes share a card.
- `process_local_indices(n, axis)` (:98) and
  `process_local_batch_columns(batch_size, axis)` (:167): the contiguous
  block of a batch, or of each eval batch's columns, that JAX's default
  mesh gives this process, under JAX's divisibility message.
- `replicate_for_processes(model, axis)` (:147): every process holds the
  state of process 0, and had it already (the same seed, the same
  checkpoint), or the run stops.
- `replicate_result(x)` (:219): the processes' tensors gathered in rank
  order.
- `assert_same_across_processes(value)` (:226).

`global_batch_from_local` (:120) and `global_prebatched_from_local` have
no counterpart: JAX assembles a global array from the processes' shards,
and here a process's tensor is its shard, fed to its own device.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from image_segmentation_tpu_torch.parallel.mesh import DataAxis, backend_for


def initialize_multihost(coordinator: str, num_processes: int, process_id: int,
                         device_type: str = "cuda") -> str:
    """Bring the process group up; a no-op when it is up. `coordinator` is
    `host:port` (process 0 serves the store there), a `tcp://` or a
    `file://` URL. The backend follows the device type and the processes
    on this host (`LOCAL_WORLD_SIZE` where a launcher sets it, else all
    of them: one host). A collective waits at most 10 minutes. Returns
    the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = backend_for(device_type,
                          int(os.environ.get("LOCAL_WORLD_SIZE", num_processes)))
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(torch.device("cuda", local % torch.cuda.device_count()))
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(minutes=10))
    return backend


def _check_divisible(n: int, axis: DataAxis) -> None:
    """JAX's contract (multihost.py:81-95): a batch-sharded length divides
    the data axis."""
    if n % axis.size != 0:
        raise ValueError(
            f"global batch/dataset length {n} does not divide the data "
            f"axis ({axis.size} shards); pad or trim to a multiple of {axis.size}")


def process_local_indices(n: int, axis: DataAxis) -> np.ndarray:
    """The rows of a length-`n` batch this process holds: the contiguous
    block [rank·n/W, (rank + 1)·n/W), as JAX's default mesh lays them."""
    _check_divisible(n, axis)
    k = n // axis.size
    return np.arange(axis.rank * k, (axis.rank + 1) * k, dtype=np.int64)


def process_local_batch_columns(batch_size: int, axis: DataAxis) -> np.ndarray:
    """The columns of every eval batch this process evaluates (the same
    contiguous block as `process_local_indices`)."""
    return process_local_indices(batch_size, axis)


def replicate_for_processes(model: torch.nn.Module, axis: DataAxis) -> None:
    """Make every process hold process 0's parameters and buffers, and
    raise, on every process, if any held other values before: a run whose
    processes start from different states trains something else. Call on
    all processes."""
    if axis.size == 1:
        return
    differ = []
    for name, t in model.state_dict().items():
        ref = t.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(ref, src=0)
        if not torch.equal(ref, t):
            differ.append(name)
            with torch.no_grad():
                t.copy_(ref)
    count = torch.tensor([len(differ)], device=axis.device)
    dist.all_reduce(count)
    if count.item():
        raise RuntimeError(
            f"the processes' initial states differ ({int(count.item())} tensors in all; "
            f"here: {differ[:5]}): build every process's state from the same seed or "
            f"checkpoint")


def replicate_result(x: torch.Tensor) -> torch.Tensor:
    """Every process's `x` (the same shape on each), concatenated along
    dim 0 in rank order, on every process. Collective."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def assert_same_across_processes(value: float, axis: DataAxis, atol: float = 0.0,
                                 name: str = "value") -> None:
    """Raise on every process if a host scalar (a loss, a metric) differs
    across processes by more than `atol`. Collective."""
    if axis.size == 1:
        return
    vals = replicate_result(torch.tensor([float(value)], dtype=torch.float64,
                                         device=axis.device)).cpu().numpy()
    if not np.allclose(vals, vals[0], atol=atol, rtol=0):
        raise AssertionError(f"{name} diverged across processes: {vals.tolist()}")
