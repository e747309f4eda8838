"""Parallelism across processes: the (data, model) mesh and its reductions
(`mesh`), the bring-up and host-side contract (`multihost`), tensor
parallelism over the ViT (`tp`), the GPipe pipeline over its blocks
(`pp`), spatial partitioning of the UNet (`sp`), and the multi-process
dry run (`dryrun`)."""
from image_segmentation_tpu_torch.parallel.mesh import DataAxis, Mesh, get_mesh
from image_segmentation_tpu_torch.parallel.multihost import (
    initialize_multihost,
    process_local_indices,
    replicate_for_processes,
)
from image_segmentation_tpu_torch.parallel.pp import (
    pipeline_blocks,
    shard_stacked_params,
    stack_block_params,
    unstack_block_params,
)
from image_segmentation_tpu_torch.parallel.sp import (
    max_spatial_shards,
    shard_batch_spatial,
)
from image_segmentation_tpu_torch.parallel.tp import clip_tp_spec, shard_params_tp

__all__ = [
    "DataAxis",
    "Mesh",
    "get_mesh",
    "shard_batch_spatial",
    "max_spatial_shards",
    "pipeline_blocks",
    "stack_block_params",
    "unstack_block_params",
    "shard_stacked_params",
    "clip_tp_spec",
    "shard_params_tp",
    "initialize_multihost",
    "process_local_indices",
    "replicate_for_processes",
]
