"""Spatial partitioning (SP): the image height split over a mesh axis.

Counterpart of image_segmentation_tpu/parallel/sp.py (`spatial_spec`,
`max_spatial_shards` :73, `shard_batch_spatial` :101). JAX annotates the
inputs' H axis and lets XLA's SPMD partitioner write the halo exchanges
that the 3×3 convs need at shard boundaries (sp.py:8-13). torch has no
partitioner, so the port writes them (`halo_exchange`) and runs the UNet
on each rank's block of rows:

  * the module path (`models/layers.py` `ConvBNRelu`, train and eval mode):
    1 row from each neighbour before every 3×3 conv; at the image's top
    and bottom edge no row comes and the conv's own zero padding acts,
    which is exactly SAME. The 2×2 pools and the stride-2 transpose convs
    are row-local when every shard's height is even at every level;
  * the K1 eval forward (`models/fused_unet.py`, `ops/kernels/blocks.py`):
    K1 pads each of its two convs with zeros and its intermediate is zero
    outside the slab, so an interior shard takes 2 rows from each side,
    runs K1 on H_local + 4 rows and crops 2 from each side (exact), and
    at the image's top or bottom edge takes none and lets K1's padding
    act (2 zero rows would make the intermediate's row -1 ReLU(bias), not
    0). K1's plan rounds H up to 16-row tiles, so the odd slab heights
    (H_local + 2 at an edge, + 4 inside) cost one more tile row.

A shard whose height is below the halo (the bottleneck at one row a
shard, which the guard admits) takes rows from past its neighbour.
BatchNorm's train-mode statistics and the losses' sums are global sums
over the world already (models/layers.py, losses/): under pure SP and
DP × SP they are exactly the sums over (N, H, W), as XLA's are
(sp.py:15-18).

Two layouts, as JAX's (sp.py:20-27), over a (data, model) mesh
(parallel/mesh.py): pure SP, H on 'data' and every rank holding the whole
batch (`spatial_axis=DATA_AXIS, batch_axis=None`); and DP × SP, the batch
on 'data' and H on 'model' (`spatial_axis=MODEL_AXIS,
batch_axis=DATA_AXIS`).

Two divergences from JAX. XLA pads ragged shards; the port does not, so a
height whose shard is not a multiple of the model's downsample factor is
refused, naming both numbers. And SP covers the UNet, the model JAX tests
and dry-runs it on (test_sp.py, __graft_entry__.py:209-235):
`partition_model` refuses any other, naming it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import torch

from image_segmentation_tpu_torch.parallel.mesh import DATA_AXIS, DataAxis, Mesh, gather_slots

# Height is dim 1 for both NHWC images and NHW integer label maps.
_SPATIAL_DIM = 1


@dataclasses.dataclass(frozen=True)
class SpatialAxis:
    """The mesh axis that holds H: its process group (None: the world), its
    size and this rank's index on it."""

    group: Any
    size: int
    index: int


def spatial_spec(ndim: int, spatial_axis: str = DATA_AXIS,
                 batch_axis: Optional[str] = None) -> Tuple[Optional[str], ...]:
    """Which mesh axis holds each dim of one batch array, as JAX's
    PartitionSpec lists them: dim 0 on `batch_axis` (None: every rank holds
    it all), dim 1 (height) on `spatial_axis`, the rest whole. Arrays
    without a spatial dim (ndim < 3) split their batch dim only."""
    if ndim >= 3:
        return (batch_axis, spatial_axis)
    if ndim >= 1:
        return (batch_axis,)
    return ()


def spatial_axis_of(mesh: Mesh, spatial_axis: str = DATA_AXIS) -> SpatialAxis:
    return SpatialAxis(*mesh.axis(spatial_axis))


def max_spatial_shards(height: int, downsample_factor: int = 16) -> int:
    """The SP envelope, as JAX states it (sp.py:73-99): at most
    `height // downsample_factor` shards (the model's bottleneck rows). The
    guard's reason is XLA's: past it, XLA SPMD's padded-shard backward is
    silently wrong. The port's halo reaches past a neighbour and pads no
    shard, but keeps JAX's envelope and message."""
    return max(1, height // downsample_factor)


def _check_height(h: int, shards: int, downsample_factor: int) -> None:
    if h // downsample_factor < shards:
        raise ValueError(
            f"spatial sharding {shards}-way needs bottleneck height "
            f"H/{downsample_factor} >= {shards}, got H={h}: XLA's "
            "padded-shard backward is silently wrong below that "
            "(see shard_batch_spatial docstring)")
    if h % shards or (h // shards) % downsample_factor:
        raise ValueError(
            f"spatial sharding {shards}-way of H={h} gives shards of {h / shards:g} rows, "
            f"not a multiple of the downsample factor {downsample_factor}: every level's "
            f"pool must stay inside a shard (ragged shards are not padded)")


def shard_batch_spatial(batch, mesh: Mesh, spatial_axis: str = DATA_AXIS,
                        batch_axis: Optional[str] = None, downsample_factor: int = 16):
    """This rank's part of every array of `batch` (a tensor or ndarray, or a
    tuple, list or dict of them): its contiguous block of H (dim 1) for the
    arrays with one (ndim ≥ 3), and with `batch_axis` its contiguous block
    of rows (dim 0).

    JAX's guard stays (sp.py:129-137): the model's smallest height
    (H / `downsample_factor`, 16 for the 5-level UNet) must be at least the
    number of shards; JAX's reason is that XLA's ragged-shard padding makes
    the backward silently wrong below it. The port also refuses a shard
    height that is not a multiple of `downsample_factor` (the pools would
    cross shards). Pass the model's true factor (1 for a conv-only model)
    to relax both."""
    from image_segmentation_tpu_torch.parallel.multihost import process_local_indices

    sp = spatial_axis_of(mesh, spatial_axis)
    rows = None if batch_axis is None else DataAxis(*mesh.axis(batch_axis)[1:], mesh.device)

    def take(x):
        nd = getattr(x, "ndim", 0)
        if nd >= 3:
            _check_height(x.shape[_SPATIAL_DIM], sp.size, downsample_factor)
            h = x.shape[_SPATIAL_DIM] // sp.size
            x = x[:, sp.index * h:(sp.index + 1) * h]
        if rows is not None and nd >= 1:
            idx = process_local_indices(x.shape[0], rows)
            x = x[idx[0]:idx[-1] + 1]
        return x

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(take(v) for v in batch)
    return take(batch)


def _halo_rows(rows: int, h: int, axis: SpatialAxis):
    """(top, bottom, k, top index, bottom index): how many rows this shard
    takes from above and below (as many of `rows` as the image has), the
    strip k = min(rows, h) each shard sends from each edge, and where each
    taken row lies in the gathered (size · 2k) strips: shard j's first
    strip at [2kj, 2kj + k), its last at [2kj + k, 2kj + 2k)."""
    k = min(rows, h)
    start, end = axis.index * h, (axis.index + 1) * h
    top = min(rows, start)
    bottom = min(rows, axis.size * h - end)

    def where(g, first):
        j, o = divmod(g, h)
        return 2 * k * j + (o if first else k + o - (h - k))

    idx_top = [where(g, False) for g in range(start - top, start)]
    idx_bot = [where(g, True) for g in range(end, end + bottom)]
    return top, bottom, k, idx_top, idx_bot


def halo_exchange(x: torch.Tensor, rows: int, axis: SpatialAxis,
                  dim: int = _SPATIAL_DIM) -> Tuple[torch.Tensor, int, int]:
    """(slab, top, bottom): this shard's `x` with up to `rows` rows of its
    neighbours' on each side along `dim` (fewer at the image's edges: top
    is 0 on the first shard, bottom on the last), differentiable. An op
    that pads SAME, applied to the slab and cropped by `top` and `bottom`,
    gives this shard's rows of the op on the whole image. Every shard of
    the axis must call it, in the same order.

    Each shard's first and last k rows travel in one `gather_slots`, and
    this shard picks the rows it needs from them; autograd gives the
    adjoint (the gradients of the received rows go back to their owners
    and are added to the rows they came from)."""
    if axis.size == 1:
        return x, 0, 0
    h = x.shape[dim]
    top, bottom, k, idx_top, idx_bot = _halo_rows(rows, h, axis)
    edges = torch.cat([x.narrow(dim, 0, k), x.narrow(dim, h - k, k)], dim)
    strips = gather_slots(edges, axis.group, axis.size, axis.index)
    strips = strips.movedim(0, dim).flatten(dim, dim + 1)  # shard j's at [2kj, 2kj + 2k)
    got = strips.index_select(dim, torch.tensor(idx_top + idx_bot, device=x.device))
    return torch.cat([got.narrow(dim, 0, top), x, got.narrow(dim, top, bottom)], dim), top, bottom


def crop_rows(y: torch.Tensor, top: int, bottom: int, dim: int = _SPATIAL_DIM) -> torch.Tensor:
    """`y` without its first `top` and last `bottom` rows along `dim`."""
    return y.narrow(dim, top, y.shape[dim] - top - bottom)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("spatial_partition", default=None)


def active() -> Optional[SpatialAxis]:
    """The spatial axis a model's layers run over, inside `partitioned`."""
    return _ACTIVE.get()


@contextlib.contextmanager
def partitioned(axis: Optional[SpatialAxis]):
    """Run the enclosed layers on row blocks of `axis` (None: no SP)."""
    token = _ACTIVE.set(axis)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def partition_model(model: torch.nn.Module, mesh: Mesh,
                    spatial_axis: str = DATA_AXIS) -> torch.nn.Module:
    """Make `model` run on this rank's block of H over `mesh`'s
    `spatial_axis` (its `spatial`). SP covers the UNet only (module
    docstring); any other model raises, naming it. Returns `model`."""
    from image_segmentation_tpu_torch.models.unet import UNet

    if not isinstance(model, UNet):
        raise TypeError(f"spatial partitioning covers the UNet, the model JAX runs it on; "
                        f"got {type(model).__name__}")
    axis = spatial_axis_of(mesh, spatial_axis)
    model.spatial = axis if axis.size > 1 else None
    return model


def local_height_check(h: int, axis: Optional[SpatialAxis], downsample_factor: int = 16) -> None:
    """Refuse a local slab whose height is not a multiple of the model's
    downsample factor under SP (the pools would cross shards)."""
    if axis is not None and h % downsample_factor:
        raise ValueError(f"a shard of {h} rows is not a multiple of the downsample factor "
                         f"{downsample_factor} (spatial partitioning over {axis.size} shards)")

