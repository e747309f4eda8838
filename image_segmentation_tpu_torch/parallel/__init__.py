"""Data parallelism across processes: the data axis and its reductions
(`mesh`), the bring-up and host-side contract (`multihost`)."""
from image_segmentation_tpu_torch.parallel.mesh import DataAxis, get_mesh
from image_segmentation_tpu_torch.parallel.multihost import (
    initialize_multihost,
    process_local_indices,
    replicate_for_processes,
)

__all__ = [
    "DataAxis",
    "get_mesh",
    "initialize_multihost",
    "process_local_indices",
    "replicate_for_processes",
]
