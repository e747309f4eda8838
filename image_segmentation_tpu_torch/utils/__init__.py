"""Host utilities: the safetensors reader and the CLIP weight converter."""
