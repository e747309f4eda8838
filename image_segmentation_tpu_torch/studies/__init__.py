"""The reference report's studies and the parity rehearsals, each
runnable as `python -m image_segmentation_tpu_torch.studies.<name>`: the
8 x 10 robustness sweep (`robustness`), its pipeline from a pseudo-Pet
tree to both UNet rows' curves (`robustness_pipeline`), the controlled
comparisons (`ablations`), the BatchNorm regime (`bn_regime`) and the
reference recipe against the port's trainer (`convergence_rehearsal`).
Counterparts of the JAX repository's benchmarks/{robustness,
robustness_pipeline,ablations,bn_regime,convergence_rehearsal}.py."""

import torch


def cli_device(name: str) -> torch.device:
    """A CLI's --device: the card unless the caller asks for the CPU; a card
    asked for and missing ends the run with a message."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    return device


def device_kind(device) -> str:
    """The card's name, or the device type off a card."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
