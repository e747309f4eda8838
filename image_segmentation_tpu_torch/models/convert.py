"""JAX (flax) variables → the port's state_dict, in numpy and torch only.

`from_jax_variables` takes the flax `{'params', 'batch_stats'}` tree of a
ClipUNet, a ClipUNetNoSkips, a ClipUNetDecoderOnly, a UNet, a
SegmentationAutoencoder, a ReconstructionAutoencoder or a PromptModel, or the
`{'params'}` tree of a bare ClipViT, as nested dicts of numpy arrays, and
returns the state_dict of the port's module:

  Dense          kernel (in, out)        → weight (out, in)
  Conv           kernel HWIO             → weight OIHW
  ConvTranspose  kernel (kH, kW, I, O)   → spatially flipped, → (I, O, kH, kW)
                 (flax applies the kernel unflipped, torch as a true
                 transposed convolution; the inverse of
                 image_segmentation_tpu/models/torch_import.py:48-53)
  BatchNorm      scale/bias, mean/var    → weight/bias, running_mean/running_var
  LayerNorm      scale/bias              → weight/bias
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _dense(p) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _conv(p) -> Dict[str, torch.Tensor]:
    out = {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _conv_transpose(p) -> Dict[str, torch.Tensor]:
    k = np.asarray(p["kernel"])[::-1, ::-1]
    return {"weight": _t(k.transpose(2, 3, 0, 1)), "bias": _t(p["bias"])}


def _norm(p) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _vit(p: Mapping) -> Dict[str, torch.Tensor]:
    sd = {
        "embeddings.class_embedding": _t(p["class_embedding"]),
        "embeddings.position_embedding.weight": _t(p["position_embedding"]),
        "embeddings.patch_embedding.weight": _conv(p["patch_embedding"])["weight"],
    }
    sd.update({f"pre_layrnorm.{k}": v for k, v in _norm(p["pre_layernorm"]).items()})
    n_layers = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layers):
        b, pre = p[f"block_{i}"], f"encoder.layers.{i}."
        parts = {
            "layer_norm1": _norm(b["ln1"]),
            "layer_norm2": _norm(b["ln2"]),
            "mlp.fc1": _dense(b["fc1"]),
            "mlp.fc2": _dense(b["fc2"]),
            **{f"self_attn.{n}": _dense(b["attn"][n])
               for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        }
        for name, tensors in parts.items():
            sd.update({f"{pre}{name}.{k}": v for k, v in tensors.items()})
    return sd


def _conv_bn_relu(p, stats) -> Dict[str, torch.Tensor]:
    sd = {f"conv.{k}": v for k, v in _conv(p["Conv_0"]).items()}
    sd.update({f"bn.{k}": v for k, v in _norm(p["BatchNorm_0"]).items()})
    sd["bn.running_mean"] = _t(stats["BatchNorm_0"]["mean"])
    sd["bn.running_var"] = _t(stats["BatchNorm_0"]["var"])
    return sd


def _double_conv(p, stats) -> Dict[str, torch.Tensor]:
    sd = {}
    for i in (0, 1):
        name = f"ConvBNRelu_{i}"
        sd.update({f"conv{i + 1}.{k}": v
                   for k, v in _conv_bn_relu(p[name], stats[name]).items()})
    return sd


def _unet(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """DoubleConv_0 → down1, Down_k → down{k+2}, Up_k → up{k+1}, Conv_0 → output."""
    parts = {"down1": _double_conv(params["DoubleConv_0"], stats["DoubleConv_0"]),
             "output": _conv(params["Conv_0"])}
    for k in range(4):
        d = f"Down_{k}"
        parts[f"down{k + 2}.conv"] = _double_conv(params[d]["DoubleConv_0"],
                                                  stats[d]["DoubleConv_0"])
        u = f"Up_{k}"
        parts[f"up{k + 1}.up.up"] = _conv_transpose(params[u]["UpConv_0"]["ConvTranspose_0"])
        parts[f"up{k + 1}.conv"] = _double_conv(params[u]["DoubleConv_0"],
                                                stats[u]["DoubleConv_0"])
    return {f"{name}.{k}": v for name, tensors in parts.items() for k, v in tensors.items()}


def _prefixed(prefix: str, sd: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _clip_decoder(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """init_conv, dec_i and head of any of the three ClipUNet modules; a
    block with `skip_proj` is a skip block, one without a no-skip block."""
    sd = {}
    for name in ("init_conv", "head"):
        sd.update(_prefixed(name, _conv(params[name])))
    n_blocks = sum(1 for k in params if k.startswith("dec_"))
    for i in range(n_blocks):
        p, s, pre = params[f"dec_{i}"], stats[f"dec_{i}"], f"dec.{i}."
        parts = {
            "up.up": _conv_transpose(p["UpConv_0"]["ConvTranspose_0"]),
            "conv1": _conv_bn_relu(p["ConvBNRelu_0"], s["ConvBNRelu_0"]),
            "conv2": _conv_bn_relu(p["ConvBNRelu_1"], s["ConvBNRelu_1"]),
        }
        if "skip_proj" in p:
            parts["skip_proj"] = _conv(p["skip_proj"])
        for name, tensors in parts.items():
            sd.update({f"{pre}{name}.{k}": v for k, v in tensors.items()})
    return sd


def _clip_unet(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """A ClipUNet or a ClipUNetNoSkips: the ViT under `vision_model`."""
    return {**_prefixed("vision_model", _vit(params["encoder"])),
            **_clip_decoder(params, stats)}


def _autoencoder(params: Mapping, stats: Mapping, skips: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """encoder/EncoderBlock_k → encoder.encoderPart{k+1},
    DecoderBlockWithSkips_k (or DecoderBlockNoSkips_k) → decoder.decoderBlock{k+1},
    Conv_0 → finalConv (or the reconstruction's decoderOut.0); inside them
    ConvBNRelu_{0,1} → conv{1,2} and UpConv_0 → up."""
    sd = _prefixed("finalConv" if skips else "decoderOut.0", _conv(params["Conv_0"]))
    block = "DecoderBlockWithSkips" if skips else "DecoderBlockNoSkips"
    for k in range(3):
        e, d = f"EncoderBlock_{k}", f"{block}_{k}"
        for pre, p, s in ((f"encoder.encoderPart{k + 1}", params["encoder"][e],
                           stats["encoder"][e]),
                          (f"decoder.decoderBlock{k + 1}", params[d], stats[d])):
            for i in (0, 1):
                name = f"ConvBNRelu_{i}"
                sd.update(_prefixed(f"{pre}.conv{i + 1}", _conv_bn_relu(p[name], s[name])))
        sd.update(_prefixed(f"decoder.decoderBlock{k + 1}.up.up",
                            _conv_transpose(params[d]["UpConv_0"]["ConvTranspose_0"])))
    return sd


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX ClipUNet, ClipUNetNoSkips,
    ClipUNetDecoderOnly, UNet, SegmentationAutoencoder,
    ReconstructionAutoencoder, PromptModel or bare ClipViT tree, told apart
    by what the tree holds: a ClipUNet or ClipUNetNoSkips has
    `encoder/class_embedding` (the two differ in their blocks' `skip_proj`),
    a ClipUNetDecoderOnly `init_conv` and no encoder, an autoencoder
    `encoder/EncoderBlock_0` (the reconstruction one `DecoderBlockNoSkips_0`
    beside it), a PromptModel `clip` and `mask`, a UNet `DoubleConv_0`, a
    bare ClipViT `class_embedding`. Any other tree raises."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    encoder = params.get("encoder", {})
    if "clip" in params and "mask" in params:
        return {**_prefixed("clip", _clip_unet(params["clip"], stats["clip"])),
                **_prefixed("mask", _unet(params["mask"], stats["mask"]))}
    if "DoubleConv_0" in params:
        return _unet(params, stats)
    if "class_embedding" in encoder:
        return _clip_unet(params, stats)
    if "init_conv" in params and "encoder" not in params:
        return _clip_decoder(params, stats)
    if "EncoderBlock_0" in encoder:
        return _autoencoder(params, stats, skips="DecoderBlockNoSkips_0" not in params)
    if "class_embedding" in params:
        return _vit(params)
    raise ValueError(
        f"unknown JAX variables tree (top-level params {sorted(params)}): not a "
        f"ClipUNet, ClipUNetNoSkips, ClipUNetDecoderOnly, UNet, autoencoder, "
        f"PromptModel or ClipViT")
