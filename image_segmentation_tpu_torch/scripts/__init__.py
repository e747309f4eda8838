"""The user-facing scripts of the reference study, each runnable as
`python -m image_segmentation_tpu_torch.scripts.<name>`: converting an
Oxford-IIIT Pet download (`prepare_oxford_pet`), the one-command reference
table (`reproduce_reference`) and the converged-run script (`fullscale`).
Counterparts of the JAX repository's scripts/*.py."""
