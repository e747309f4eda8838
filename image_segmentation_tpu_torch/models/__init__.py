"""PyTorch models: the CLIP ViT encoder and the ClipUNet."""
