"""Host geometry (numpy) and the hand-written CUDA kernels (ops.kernels).

The kernels' launch counters are read and credited here (`launch_counts`,
`launches_since`, `add_launches`): a CUDA graph's replay (train/graphs.py)
launches kernels without calling their wrappers."""

from image_segmentation_tpu_torch.ops.kernels._build import (  # noqa: F401
    add_launches,
    launch_counts,
    launches_since,
)
