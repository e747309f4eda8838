"""Tensor parallelism (Megatron) over the CLIP ViT encoder.

Counterpart of image_segmentation_tpu/parallel/tp.py (`clip_tp_spec` :29,
`shard_params_tp` :41). The attention q/k/v projections and the MLP's fc1
split their OUTPUT features over the mesh's model axis (whole heads and
F/T hidden units stay rank-local), and out_proj and fc2 split their INPUT
features, so one all-reduce per attention and one per MLP sums the
partial outputs. JAX writes the splits as sharding annotations and lets
GSPMD insert the collectives; the port keeps each rank's slices
(`shard_params_tp`) and writes the two operators out:

  * `copy_to_model`: identity forward, all-reduce of the gradient over the
    model group backward, on every replicated input of the column-parallel
    projections (the attention's LayerNorm output; the MLP's x and its
    LayerNorm parameters, since K4's TP entry normalises inside);
  * `reduce_from_model`: all-reduce over the model group forward (in f32,
    of the row-parallel partial sums), identity backward.

The blocks (models/clip_vit.py) take the split from the parameters they
hold: K3 on the local heads, K4's TP entry (`fused_mlp_partial`) on the
local F columns. Why the gradient of a sharded parameter is reduced over
the data group alone, and with what scale, is in parallel/mesh.py;
`train.steps.train_step` does it for the parameters this marks
(`tp_split_dim`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from image_segmentation_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, sum_replicated

_COLUMN = ("q_proj", "k_proj", "v_proj", "fc1")
_ROW = ("out_proj", "fc2")


def clip_tp_spec(name: str) -> Optional[int]:
    """Which dim of a ViT parameter (by its '.'-joined name, torch's (out, in)
    weight layout) is split over the model axis, or None: 0 for the q/k/v
    and fc1 weights and biases, 1 for the out_proj and fc2 weights, none
    for their biases and every other parameter (JAX's P(None, 'model'),
    P('model'), P('model', None) and P() on flax's (in, out) kernels)."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
    if parent in _COLUMN:
        return 0
    if parent in _ROW and leaf == "weight":
        return 1
    return None


def _in_encoder(name: str, prefix: Optional[str]) -> bool:
    return prefix is None or prefix in name.split(".")


def shard_params_tp(model: torch.nn.Module, mesh: Mesh,
                    encoder_prefix: Optional[str] = "encoder") -> torch.nn.Module:
    """Keep this rank's slices of the ViT's split parameters (those under a
    module named `encoder_prefix`; every parameter with None), in place:
    the contiguous block [m·n/T, (m+1)·n/T) of the split dim for model rank
    m of T. A dim that does not divide by T stays whole, as JAX's does
    (tp.py:58-65). Each split parameter gets `tp_split_dim`, each block
    holding one its `tp_mesh`, and the model its `tp_mesh`. Build the
    optimizer after this. Returns `model`."""
    t = mesh.model_size
    if t == 1:
        return model
    splits = {}
    for name, p in model.named_parameters():
        dim = clip_tp_spec(name) if _in_encoder(name, encoder_prefix) else None
        if dim is not None and p.shape[dim] % t == 0:
            splits[name] = dim
    for mod_name, mod in model.named_modules():
        q = f"{mod_name}.q_proj.weight"
        if q in splits and mod.cfg.num_heads % t:
            raise ValueError(f"{mod_name}: {mod.cfg.num_heads} heads do not split over a "
                             f"model axis of {t}; tensor parallelism keeps whole heads")
    for name, p in model.named_parameters():
        if name in splits:
            dim, n = splits[name], p.shape[splits[name]] // t
            with torch.no_grad():
                p.data = p.data.narrow(dim, mesh.model_rank * n, n).clone()
            p.tp_split_dim = dim
    for mod_name, mod in model.named_modules():
        # the attention runs split when its q/k/v are, the block its MLP when fc1 is
        attn = f"{mod_name}.q_proj.weight" in splits
        mlp = f"{mod_name}.mlp.fc1.weight" in splits
        if attn or mlp:
            mod.tp_mesh = mesh
    model.tp_mesh = mesh
    return model


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Before a column-parallel projection (module docstring)."""
    return _CopyToModel.apply(x, mesh.axis(MODEL_AXIS)[0])


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """After a row-parallel projection (module docstring)."""
    return sum_replicated(x, mesh.axis(MODEL_AXIS)[0])
