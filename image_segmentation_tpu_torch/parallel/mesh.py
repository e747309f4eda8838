"""The data axis of a run across processes, and the reductions over it.

Counterpart of image_segmentation_tpu/parallel/mesh.py
(`init_distributed` :27, `get_mesh` :49). JAX lays every device of the job
on a 'data' mesh axis and runs one program over it: under `jit` XLA
shards the batch and inserts every reduction the math needs (the
gradient sums, and the BatchNorm statistics and loss sums over the global
batch). The port runs one process per device with `torch.distributed`,
so the data axis is the process group: `DataAxis` is its size, this
process's rank and this process's device.

`shard_batch` and `replicate` have no counterpart here. In a world of one
device per process a process's tensor is its shard: the caller picks its
rows (parallel/multihost.py), and every process builds the same state
from the same seed (`multihost.replicate_for_processes` checks that it
did). There is no model axis: tensor, sequence and pipeline parallelism
are not ported.

The reductions XLA would insert are written out: `all_reduce_sum` for the
BatchNorm statistics (models/layers.py) and the losses' numerators and
denominators (losses/), and `all_reduce_` for the gradients
(train/steps.py). Each is the identity outside a group of more than one
process, so a single-process run computes what it always did.

Why the sums give the single-process gradient. `all_reduce_sum` maps the
processes' (x_1 .. x_W) to y_r = Σ_q x_q on every process; its adjoint
sums the upstream gradients, g(x_r) = Σ_q g(y_q), and that is what its
backward computes. Every process forms the same global loss L from the
reduced sums and starts its backward from dL = 1, so together the W
backwards differentiate W·L with respect to each process's copy of the
parameters, and the true gradient of the shared parameters is the sum of
the copies' gradients over processes. `train_step` sums the gradients
over processes (`all_reduce_`) and divides by W (and by the accumulation
count): W·∂L/∂θ / W = ∂L/∂θ, the gradient of one process that held the
whole micro-batch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The process group as a data axis: `size` processes, this one's
    `rank`, and the device this process drives."""

    size: int
    rank: int
    device: torch.device


def world_size() -> int:
    """The number of processes in the initialised group, else 1."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host: `LOCAL_RANK` where a launcher sets
    it (torchrun does), else the global rank."""
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def process_device(device_type: str) -> torch.device:
    """The device of this process: the CPU, or card local rank % cards."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % max(1, torch.cuda.device_count()))


def backend_for(device_type: str, processes_on_host: int) -> str:
    """gloo on the CPU; NCCL when every process of a host has a card of its
    own; gloo when processes share a card (NCCL takes one rank a card)."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if processes_on_host <= torch.cuda.device_count() else "gloo"


def init_distributed(device_type: str = "cuda") -> bool:
    """Bring the group up from a launcher's environment (`MASTER_ADDR`,
    `MASTER_PORT`, `WORLD_SIZE`, `RANK`, as torchrun sets them). A no-op
    when the group is up already or the environment names none (JAX's
    single-host case). Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    size = int(os.environ["WORLD_SIZE"])
    backend = backend_for(device_type, int(os.environ.get("LOCAL_WORLD_SIZE", size)))
    if backend == "nccl":
        torch.cuda.set_device(process_device(device_type))
    dist.init_process_group(backend, init_method="env://")
    return True


def get_mesh(device_type: str = "cuda") -> DataAxis:
    """The data axis over every process of the group (one process, rank 0,
    when no group is up)."""
    if not dist.is_initialized():
        return DataAxis(1, 0, process_device(device_type))
    return DataAxis(dist.get_world_size(), dist.get_rank(), process_device(device_type))


class _AllReduceSum(torch.autograd.Function):
    """Σ over processes; the backward sums the upstream gradients over
    processes (the adjoint, module docstring)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ of `x` over the processes of the group, differentiable; `x` itself
    outside a group of more than one process."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


def global_sums(*xs: torch.Tensor) -> Sequence[torch.Tensor]:
    """Each of `xs` summed over the processes in one differentiable
    all-reduce (the tensors share a dtype); `xs` unchanged outside a
    group."""
    if world_size() == 1:
        return xs
    flat = all_reduce_sum(torch.cat([x.reshape(-1) for x in xs]))
    return tuple(t.view_as(x) for t, x in zip(flat.split([x.numel() for x in xs]), xs))


def all_reduce_(tensors: List[torch.Tensor]) -> None:
    """Sum `tensors` over the processes in place, through one flat buffer
    (one collective, not one a tensor)."""
    if world_size() == 1 or not tensors:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat)
    for t, r in zip(tensors, torch._utils._unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)


def any_process(flag: bool, device) -> bool:
    """Whether `flag` is set on any process (a stop request that one
    process received, so that every process stops at the same epoch)."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
