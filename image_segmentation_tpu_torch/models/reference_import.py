"""Import checkpoints trained with the reference repository (torch state
dicts) into the port's models.

The port's counterpart of image_segmentation_tpu/models/torch_import.py:
the reference's torch layouts (reference unet/unet.py:67-105, both stages
of autoencoder/autoencoder.py, clip/clipunet.py and its no-skips variant,
prompt_based/prompt.py) map to the port's `state_dict`, BatchNorm running
statistics included, so an imported model evaluates with its trained
statistics. Both sides are torch, so every tensor keeps its layout: a
ConvTranspose2d weight is NOT flipped (the flip of torch_import.py:16-19
reconciles torch with flax, and belongs to that path only). BatchNorm's
`num_batches_tracked` has no counterpart (the port's BatchNorm keeps
flax's momentum form) and is dropped.

`convert_reference_state_dict(sd, arch)` takes a full reference
checkpoint `{'model_state_dict': ...}` (reference utils/training.py:
564-609) or a bare `MO_` state dict, and `arch` one of "unet",
"autoencoder" (the stage is read from the keys), "clipunet" (with or
without skips, read from the keys) and "prompt". It returns (the port's
state_dict, the port config it loads into).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from image_segmentation_tpu_torch.config import (
    AUTOENCODER,
    CLIPUNET,
    CLIPUNET_NOSKIPS,
    PROMPT,
    RECON_AE,
    UNET_NOAUG,
    ExperimentConfig,
)

ARCHS = ("unet", "autoencoder", "clipunet", "prompt")


def _sub(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under `prefix.`, with the prefix cut off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _tensor(v) -> torch.Tensor:
    return v.detach().to("cpu", torch.float32).clone()


def _move(out: Dict[str, torch.Tensor], sd: Mapping, src: str, dst: str,
          names=("weight", "bias")) -> None:
    for name in names:
        if f"{src}.{name}" in sd:
            out[f"{dst}.{name}"] = _tensor(sd[f"{src}.{name}"])


def _conv_bn(out, sd, conv: str, bn: str, dst: str) -> None:
    """A conv (bias or none) and the BatchNorm after it → dst.conv, dst.bn."""
    _move(out, sd, conv, f"{dst}.conv")
    _move(out, sd, bn, f"{dst}.bn", ("weight", "bias", "running_mean", "running_var"))


def _double_conv(out, sd, src: str, dst: str) -> None:
    """Sequential(Conv, BN, ReLU, Conv, BN, ReLU) → dst.conv1, dst.conv2."""
    _conv_bn(out, sd, f"{src}.0", f"{src}.1", f"{dst}.conv1")
    _conv_bn(out, sd, f"{src}.3", f"{src}.4", f"{dst}.conv2")


def unet_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """reference down1.doubleConvReLU, downK.maxpool_doubleConv.1.doubleConvReLU,
    upK.upsample / upK.doubleConv.doubleConvReLU, output → the port's UNet
    (down1, downK.conv, upK.up.up / upK.conv, output); any base."""
    out: Dict[str, torch.Tensor] = {}
    _double_conv(out, sd, "down1.doubleConvReLU", "down1")
    for k in range(2, 6):
        _double_conv(out, sd, f"down{k}.maxpool_doubleConv.1.doubleConvReLU", f"down{k}.conv")
    for k in range(1, 5):
        _move(out, sd, f"up{k}.upsample", f"up{k}.up.up")
        _double_conv(out, sd, f"up{k}.doubleConv.doubleConvReLU", f"up{k}.conv")
    _move(out, sd, "output", "output")
    return out


def autoencoder_state_dict(sd: Mapping) -> Tuple[Dict[str, torch.Tensor], ExperimentConfig]:
    """Either stage of the reference autoencoder, told apart by its keys:
    the SegmentationAutoencoder wraps its encoder once more
    (`encoder.encoder.encoderPartK`) and ends in `finalConv`; the
    ReconstructionAutoencoder has `encoder.encoderPartK` and `decoderOut.0`."""
    seg = any(k.startswith("encoder.encoder.") for k in sd)
    enc = "encoder.encoder" if seg else "encoder"
    out: Dict[str, torch.Tensor] = {}
    for k in range(1, 4):
        src, dst = f"{enc}.encoderPart{k}", f"encoder.encoderPart{k}"
        _conv_bn(out, sd, f"{src}.conv1", f"{src}.bn1", f"{dst}.conv1")
        _conv_bn(out, sd, f"{src}.conv2", f"{src}.bn2", f"{dst}.conv2")
        blk = f"decoder.decoderBlock{k}"
        _move(out, sd, f"{blk}.up", f"{blk}.up.up")
        _double_conv(out, sd, f"{blk}.convs", blk)
    head = "finalConv" if seg else "decoderOut.0"
    _move(out, sd, head, head)
    return out, AUTOENCODER if seg else RECON_AE


def clipunet_state_dict(sd: Mapping) -> Tuple[Dict[str, torch.Tensor], ExperimentConfig]:
    """reference ClipUNet or ClipUNetNoSkips (a block with `skip_conv` is a
    skip block): the HF vision tower under `encoder.clip_vit.vision_model`
    through the CLIP weight path's HF-name mapping (models/clip_vit.py,
    which drops `post_layernorm` and `position_ids` as JAX's does), then
    decoder.init_conv → init_conv, decoder_blocks.i.{upsample, skip_conv,
    conv_block.{0,1,3,4}} → dec.i.{up.up, skip_proj, conv1, conv2},
    output_layer → head."""
    from image_segmentation_tpu_torch.models.clip_vit import hf_vision_state

    out = {f"vision_model.{k}": v
           for k, v in hf_vision_state(_sub(sd, "encoder.clip_vit")).items()}
    _move(out, sd, "decoder.init_conv", "init_conv")
    blocks = sorted({int(k.split(".")[2]) for k in sd if k.startswith("decoder.decoder_blocks.")})
    skips = any(".skip_conv." in k for k in sd)
    for i in blocks:
        src, dst = f"decoder.decoder_blocks.{i}", f"dec.{i}"
        _move(out, sd, f"{src}.upsample", f"{dst}.up.up")
        _move(out, sd, f"{src}.skip_conv", f"{dst}.skip_proj")
        _double_conv(out, sd, f"{src}.conv_block", dst)
    _move(out, sd, "output_layer", "head")
    return out, CLIPUNET if skips else CLIPUNET_NOSKIPS


def prompt_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """reference PromptModel: `clip.*` a full ClipUNet, `mask.*` a 4-in,
    1-out UNet (reference prompt_based/prompt.py:15-16)."""
    clip, _ = clipunet_state_dict(_sub(sd, "clip"))
    out = {f"clip.{k}": v for k, v in clip.items()}
    out.update({f"mask.{k}": v for k, v in unet_state_dict(_sub(sd, "mask")).items()})
    return out


def convert_reference_state_dict(state_dict: Mapping, arch: str
                                 ) -> Tuple[Dict[str, torch.Tensor], ExperimentConfig]:
    """A reference checkpoint (full or `MO_`) of `arch` → (the port's
    state_dict, the config whose model it loads into)."""
    sd = state_dict.get("model_state_dict", state_dict)
    if arch == "unet":
        return unet_state_dict(sd), UNET_NOAUG
    if arch == "autoencoder":
        return autoencoder_state_dict(sd)
    if arch == "clipunet":
        return clipunet_state_dict(sd)
    if arch == "prompt":
        return prompt_state_dict(sd), PROMPT
    raise ValueError(f"unknown arch {arch!r}; one of {ARCHS}")
