"""Host geometry (numpy) and the hand-written CUDA kernels (ops.kernels)."""
