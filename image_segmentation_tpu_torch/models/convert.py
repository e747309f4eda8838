"""JAX (flax) variables → the port's state_dict, in numpy and torch only.

`from_jax_variables` takes the flax `{'params', 'batch_stats'}` tree of a
ClipUNet, or the `{'params'}` tree of a bare ClipViT, as nested dicts of
numpy arrays, and returns the state_dict of the port's module:

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


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX ClipUNet (or bare ClipViT) tree."""
    params = variables["params"]
    if "encoder" not in params:
        return _vit(params)
    stats = variables["batch_stats"]
    sd = {f"vision_model.{k}": v for k, v in _vit(params["encoder"]).items()}
    for name in ("init_conv", "head"):
        sd.update({f"{name}.{k}": v for k, v in _conv(params[name]).items()})
    n_blocks = sum(1 for k in params if k.startswith("dec_"))
    for i in range(n_blocks):
        p, s, pre = params[f"dec_{i}"], stats[f"dec_{i}"], f"dec.{i}."
        parts = {
            "up.up": _conv_transpose(p["UpConv_0"]["ConvTranspose_0"]),
            "skip_proj": _conv(p["skip_proj"]),
            "conv1": _conv_bn_relu(p["ConvBNRelu_0"], s["ConvBNRelu_0"]),
            "conv2": _conv_bn_relu(p["ConvBNRelu_1"], s["ConvBNRelu_1"]),
        }
        for name, tensors in parts.items():
            sd.update({f"{pre}{name}.{k}": v for k, v in tensors.items()})
    return sd
