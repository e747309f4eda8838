"""The reference U-Net at its published widths: the served model (the
port's `UNet`, as its `unet_noaug` config builds it), the plain reference
beside it, their seeded weights, and the analytic FLOP count."""
from __future__ import annotations

import math

import torch

from perfbench import counts, harness
from perfbench.reference.ops import Ops
from perfbench.reference.unet import UNet as ReferenceUNet

FROZEN = ()


def port(cfg: dict, device) -> torch.nn.Module:
    """The port's UNet as `config.build_model` makes it (the configuration's
    compute dtype and K1 on a card, float32 on the CPU), without its
    initialisation."""
    from image_segmentation_tpu_torch.models import layers
    from image_segmentation_tpu_torch.models.unet import UNet

    harness.require_port_norms(layers, cfg)
    cuda = torch.device(device).type == "cuda"
    with torch.device("meta"):
        model = UNet(num_classes=cfg["num_classes"], base=cfg["base"],
                     dtype=harness.compute_dtype(cfg) if cuda else torch.float32,
                     use_kernels=cuda, in_channels=cfg["in_channels"])
    return model.to_empty(device=device)


def reference(cfg: dict, ops=None) -> torch.nn.Module:
    with torch.device("meta"):
        return ReferenceUNet(cfg["base"], cfg["num_classes"], cfg["in_channels"],
                             (ops or Ops()).configure(cfg))


def init_spec(name: str, shape) -> tuple:
    """(centre, half width) of the uniform draw for one leaf."""
    if name.endswith("running_mean"):
        return 0.0, 0.2
    if name.endswith("running_var"):
        return 1.0, 0.5
    if ".bn." in name:
        return (1.0, 0.1) if name.endswith("weight") else (0.0, 0.1)
    if len(shape) == 1:
        return 0.0, 0.05
    fan_in = shape[0] * shape[2] * shape[3] if ".up.up." in name else math.prod(shape[1:])
    return 0.0, math.sqrt(6.0 / fan_in)  # Kaiming uniform, as the reference's init


def levels(cfg: dict):
    """The nine double convs as (side, cin, c)."""
    b, s, cin = cfg["base"], cfg["image_size"], cfg["in_channels"]
    down = [(s, cin, b)] + [(s >> i, b << (i - 1), b << i) for i in range(1, 5)]
    up = [(s >> i, b << (i + 1), b << i) for i in range(3, -1, -1)]
    return down + up


def forward_flops(cfg: dict) -> float:
    """Conv and transpose-conv FLOPs of one image's forward."""
    b, s, c = cfg["base"], cfg["image_size"], cfg["num_classes"]
    flops = sum(counts.k1_counts(1, side, side, cin, co)[0] for side, cin, co in levels(cfg))
    flops += sum(counts.conv_flops((s >> (i + 1)) ** 2, b << (i + 1), b << i, 2)
                 for i in range(4))  # transpose convs, on their input pixels
    return flops + counts.conv_flops(s * s, b, c, 1)


def train_flops(cfg: dict) -> float:
    """One image's forward, then its backward (input and weight gradients),
    except the input gradient of the stem, whose input needs none."""
    stem = counts.conv_flops(cfg["image_size"] ** 2, cfg["in_channels"], cfg["base"], 3)
    return 3 * forward_flops(cfg) - stem
