"""The reference ClipUNet: a frozen CLIP ViT-B/16 at the published widths
with the skip decoder. The served model is the port's `ClipUNet` as its
`clipunet` config builds it; beside it the plain reference, the seeded
weights and the analytic FLOP count."""
from __future__ import annotations

import math

import torch

from perfbench import counts, harness
from perfbench.reference.clip import ClipUNet as ReferenceClipUNet
from perfbench.reference.ops import Ops

FROZEN = ("vision_model",)


def _vit_kwargs(cfg: dict) -> dict:
    if cfg["hidden_act"] != "quick_gelu":  # K4 and the reference's MLP compute quick GELU
        raise ValueError(f"hidden_act {cfg['hidden_act']!r}: only quick_gelu is built")
    return dict(image=cfg["image_size"], patch=cfg["patch_size"], hidden=cfg["hidden_size"],
                layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
                mlp=cfg["intermediate_size"])


def port(cfg: dict, device) -> torch.nn.Module:
    """The port's ClipUNet (the configuration's compute dtype and K3/K4 on a
    card, float32 on the CPU), frozen encoder, without its initialisation."""
    from image_segmentation_tpu_torch.models import layers
    from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
    from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig

    _vit_kwargs(cfg)
    harness.require_port_norms(layers, cfg)
    cuda = torch.device(device).type == "cuda"
    vit = ClipViTConfig(image_size=cfg["image_size"], patch_size=cfg["patch_size"],
                        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
                        num_heads=cfg["num_attention_heads"], mlp_dim=cfg["intermediate_size"],
                        layer_norm_eps=cfg["layer_norm_eps"])
    with torch.device("meta"):
        model = ClipUNet(num_classes=cfg["num_classes"],
                         decoder_channels=tuple(cfg["decoder_channels"]),
                         skip_indices=tuple(cfg["skip_indices"]), vit=vit,
                         dtype=harness.compute_dtype(cfg) if cuda else torch.float32,
                         use_kernels=cuda,
                         freeze_encoder=cfg["freeze_encoder"])
    return model.to_empty(device=device)


def reference(cfg: dict, ops=None) -> torch.nn.Module:
    with torch.device("meta"):
        return ReferenceClipUNet(**_vit_kwargs(cfg), decoder_channels=cfg["decoder_channels"],
                                 skip_indices=cfg["skip_indices"],
                                 num_classes=cfg["num_classes"],
                                 ops=(ops or Ops()).configure(cfg))


def init_spec(name: str, shape) -> tuple:
    """(centre, half width) of the uniform draw for one leaf."""
    if name.endswith("running_mean"):
        return 0.0, 0.2
    if name.endswith("running_var"):
        return 1.0, 0.5
    if ".bn." in name or "layer_norm" in name or "layrnorm" in name:
        return (1.0, 0.1) if name.endswith("weight") else (0.0, 0.1)
    if "class_embedding" in name or "position_embedding" in name:
        return 0.0, 0.02 * math.sqrt(3.0)  # the variance of N(0, 0.02)
    if len(shape) == 1:
        return 0.0, 0.05
    if name.startswith("vision_model."):  # LeCun's variance, 1 / fan_in
        return 0.0, math.sqrt(3.0 / math.prod(shape[1:]))
    fan_in = shape[0] * shape[2] * shape[3] if ".up.up." in name else math.prod(shape[1:])
    return 0.0, math.sqrt(6.0 / fan_in)


def vit_flops(cfg: dict) -> float:
    """The ViT's matrix products for one image."""
    h, f, heads = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"]
    g = cfg["image_size"] // cfg["patch_size"]
    s = g * g + 1
    per_layer = (4 * 2 * s * h * h + counts.k3_counts(1, s, heads, h // heads)[0]
                 + counts.k4_counts(s, h, f)[0])
    return counts.conv_flops(g * g, 3, h, cfg["patch_size"]) + cfg["num_hidden_layers"] * per_layer


def _decoder_layers(cfg: dict):
    """(forward FLOPs, weight gradient, input gradient) of every decoder
    layer for one image: whether training computes a gradient of its
    weights, and of its input."""
    h, g, ch = cfg["hidden_size"], cfg["image_size"] // cfg["patch_size"], cfg["decoder_channels"]
    n = min(len(ch) - 1, len(cfg["skip_indices"]))
    out = [(counts.conv_flops(g * g, h, ch[0], 1), True, False)]  # init_conv on ViT features
    side = g
    for i in range(n):
        half, up = ch[i] // 2, 2 * side
        out.append((counts.conv_flops(side * side, ch[i], half, 2), True, True))  # transpose conv
        out.append((counts.conv_flops(g * g, h, half, 1), True, False))  # skip_proj on ViT features
        if up != g:  # the skip's linear resize: rows, then columns
            out.append((2.0 * half * up * g * g + 2.0 * half * up * up * g, False, True))
        out.append((counts.conv_flops(up * up, 2 * half, ch[i + 1], 3), True, True))
        out.append((counts.conv_flops(up * up, ch[i + 1], ch[i + 1], 3), True, True))
        side = up
    out.append((counts.conv_flops(side * side, ch[n], cfg["num_classes"], 1), True, True))
    return out


def forward_flops(cfg: dict) -> float:
    return vit_flops(cfg) + sum(f for f, _, _ in _decoder_layers(cfg))


def train_flops(cfg: dict) -> float:
    """The frozen ViT's forward, the decoder's forward and its backward:
    weight gradients of every layer, input gradients where the input
    carries one (the resize has no weights: its input gradient only)."""
    return vit_flops(cfg) + sum(f * (1 + w + x) for f, w, x in _decoder_layers(cfg))
