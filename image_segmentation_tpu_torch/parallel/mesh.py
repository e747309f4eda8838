"""The (data, model) mesh of a run across processes, and the reductions
over its axes.

Counterpart of image_segmentation_tpu/parallel/mesh.py
(`init_distributed` :27, `get_mesh` :49, `DATA_AXIS`/`MODEL_AXIS`). JAX
lays every device of the job on a (data, model) mesh and runs one program
over it: under `jit` XLA shards the batch and inserts every reduction the
math needs (the gradient sums, and the BatchNorm statistics and loss sums
over the global batch). The port runs one process per device with
`torch.distributed`, so the data axis is the process group: `DataAxis` is
its size, this process's rank and this process's device.

The model axis (`get_mesh(device_type, model_parallel=T)`) is process
subgroups. The world of W processes is laid out as JAX lays its devices,
`reshape(W // T, T)`: rank r sits at (data r // T, model r % T). Its model
group is the T ranks of its row (tensor parallelism, parallel/tp.py; the
pipeline's stages, parallel/pp.py; the H shards of DP x SP,
parallel/sp.py), its data group the W / T ranks of its column. Every rank
creates every subgroup, in the same order (`dist.new_group` is itself a
collective). A `Mesh`'s `size` and `rank` are its data axis's, so the row
blocks of parallel/multihost.py and `train.steps.local_step_rows` split a
batch over the data axis only: the ranks of one model group hold the same
rows. With `model_parallel=1` the mesh is the data axis over the world and
creates no group.

`shard_batch` and `replicate` have no counterpart here. In a world of one
device per process a process's tensor is its shard: the caller picks its
rows (parallel/multihost.py), and every process builds the same state
from the same seed (`multihost.replicate_for_processes` checks that it
did).

The reductions XLA would insert are written out: `all_reduce_sum` for the
BatchNorm statistics (models/layers.py) and the losses' numerators and
denominators (losses/), and `all_reduce_` for the gradients
(train/steps.py), each over the world or over one axis's group. Each is the
identity outside a group of more than one process, so a single-process
run computes what it always did. `gather_slots` is the differentiable
all-gather that the halo exchange (parallel/sp.py) and the pipeline's
shift (parallel/pp.py) are built on. Its transport is one `all_reduce` of
a buffer in which each rank fills its own slot: gloo takes an all-reduce
of CUDA tensors (through the host), so ranks that share a card run the
same code as ranks with a card each over NCCL.

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

The same argument on a (data D, model T) mesh, where the T ranks of a
model group hold the same rows. The world sums then count every row T
times, numerator and denominator alike, so L is unchanged; and a rank's
backward reaches its activations with W·f'(s)·∂s_d/∂a, where the true
gradient of data shard d's (single) activations is T·f'(s)·∂s_d/∂a: D
times it. Tensor parallelism's operators (parallel/tp.py) keep that
factor: the row-parallel all-reduce's backward hands each model rank the
same upstream gradient, and the column-parallel identity's backward sums
the partial input gradients over the model group, so every model rank
holds D·∂L/∂(its shard) from its rows, and D·∂L/∂θ|_d for a replicated
θ. Hence:
  * a replicated parameter: Σ over the world is T·Σ_d D·∂L/∂θ|_d = W·∂L/∂θ,
    divided by W, as above;
  * a TP-sharded parameter: Σ over its data group only (its model
    neighbours hold other shards, which must never be added to it) is
    Σ_d D·∂L/∂θ_m|_d = D·∂L/∂θ_m, divided by D.
`train.steps.train_step` reduces and divides so.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The process group as a data axis: `size` processes, this one's
    `rank`, and the device this process drives."""

    size: int
    rank: int
    device: torch.device


DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh(DataAxis):
    """A (data, model) mesh over the processes (module docstring). `size` and
    `rank` are the data axis's (as in `DataAxis`); `model_size` and
    `model_rank` the model axis's. `data_group` is the process group of
    this rank's data column (None: the world, when the model axis is 1)
    and `model_group` that of its model row (None when the model axis is
    1: no collective runs over it)."""

    model_size: int = 1
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None

    def axis(self, name: str):
        """(group, size, index) of this rank on axis `name`."""
        if name == DATA_AXIS:
            return self.data_group, self.size, self.rank
        if name == MODEL_AXIS:
            return self.model_group, self.model_size, self.model_rank
        raise ValueError(f"no mesh axis {name!r}; the axes are {DATA_AXIS!r} and {MODEL_AXIS!r}")


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


def get_mesh(device_type: str = "cuda", model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over every process of the group (one process,
    rank 0, when no group is up): W // `model_parallel` rows of
    `model_parallel` ranks, rank r at (r // T, r % T), as JAX's
    `reshape(n // model_parallel, model_parallel)`. A model axis above 1
    creates the subgroups, so every process must call this, in the same
    order as every other group it creates."""
    device = process_device(device_type)
    world = world_size()
    if world % model_parallel != 0:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        return Mesh(1, 0, device)
    rank = dist.get_rank()
    if model_parallel == 1:
        return Mesh(world, rank, device)
    t, d = model_parallel, world // model_parallel
    rows = [dist.new_group(list(range(i * t, (i + 1) * t))) for i in range(d)]
    cols = [dist.new_group(list(range(j, world, t))) for j in range(t)]
    return Mesh(d, rank // t, device, model_size=t, model_rank=rank % t,
                data_group=cols[rank % t], model_group=rows[rank // t])


def group_size(group=None) -> int:
    """The processes of `group` (None: the world, `world_size()`)."""
    return world_size() if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the processes of a group; the backward sums the upstream
    gradients over them (the adjoint, module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ of `x` over the processes of `group` (None: the world),
    differentiable; `x` itself outside a group of more than one process."""
    return _AllReduceSum.apply(x, group) if group_size(group) > 1 else x


def global_sums(*xs: torch.Tensor, group=None) -> Sequence[torch.Tensor]:
    """Each of `xs` summed over the processes of `group` (None: the world)
    in one differentiable all-reduce (the tensors share a dtype); `xs`
    unchanged outside a group."""
    if group_size(group) == 1:
        return xs
    flat = all_reduce_sum(torch.cat([x.reshape(-1) for x in xs]), group)
    return tuple(t.view_as(x) for t, x in zip(flat.split([x.numel() for x in xs]), xs))


class _SumReplicated(torch.autograd.Function):
    """Σ over the processes of a group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ of `x` over the processes of `group` (None: the world), for a result
    that every process then uses alike, so that the upstream gradient is
    the same on each: the backward hands it on as it is (Megatron's
    row-parallel reduction, parallel/tp.py; the pipeline's results,
    parallel/pp.py). `all_reduce_sum`'s backward would sum it over the
    processes, for a loss that each process forms from global sums and
    that `train_step` divides by W."""
    return _SumReplicated.apply(x, group) if group_size(group) > 1 else x


class _GatherSlots(torch.autograd.Function):
    """y[q] = x of rank q, on every rank of the group: one all-reduce of a
    (size, *x.shape) buffer in which this rank fills slot `index`. The
    adjoint sums the upstream gradients over the ranks (the all-reduce's)
    and hands each rank its own slot."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.index = group, index
        buf = x.new_zeros((size,) + tuple(x.shape))
        buf[index] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index], None, None, None


def gather_slots(x: torch.Tensor, group, size: int, index: int) -> torch.Tensor:
    """Every rank's `x` (one shape on all), stacked in rank order along a new
    dim 0, on every rank of `group`; differentiable. `x[None]` for a group
    of one."""
    if size == 1:
        return x.unsqueeze(0)
    return _GatherSlots.apply(x, group, size, index)


def all_reduce_(tensors: List[torch.Tensor], group=None) -> None:
    """Sum `tensors` over the processes of `group` (None: the world) in
    place, through one flat buffer (one collective, not one a tensor)."""
    if group_size(group) == 1 or not tensors:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
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
