"""image_segmentation_tpu_torch — the PyTorch + CUDA port of image_segmentation_tpu.

It runs the JAX package's models on an NVIDIA H100 with hand-written
Hopper kernels in place of the Pallas TPU kernels, and holds itself to
the JAX package (the reference) in tests. It imports torch and numpy,
never jax. Public functions keep the JAX package's NHWC layout.
"""

__version__ = "0.1.0"

NUM_CLASSES = 4  # background, cat, dog, boundary
EVAL_IGNORE_INDEX = 3  # boundary excluded from eval metrics
