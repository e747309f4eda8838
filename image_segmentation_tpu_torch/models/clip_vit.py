"""CLIP ViT vision encoder (frozen feature extractor), eval forward.

Counterpart of image_segmentation_tpu/models/clip_vit.py, with HF
`CLIPVisionModel` parameter names (`embeddings.patch_embedding.weight`,
`encoder.layers.{i}.self_attn.q_proj.weight`, `pre_layrnorm` — sic, HF's
spelling), so converted HF weights load without renaming. Patch-embed
conv (k = s = patch, no bias), class + position embeddings, pre-layernorm,
pre-norm blocks (quick-GELU MLP), and the list of hidden states:
[0] is the pre-layernorm output and [i] the output of block i.

With `use_kernels`, each block's attention runs K3 (`fused_attention`)
and its MLP half K4 (`fused_mlp`) at the widths K4 takes
(`mlp.kernel_takes`: H in `HIDDEN_SIZES` or `MANY_TOKEN_HIDDEN`, F a
multiple of 64; the JAX package asks for multiples of 128,
clip_vit.py:161, which puts every width this repo builds a ViT at on the
same side); otherwise the plain versions of the same functions run. On
CPU tensors the wrappers run the plain versions themselves.

Parameters are float32; the compute dtype is the dtype of the pixels the
ClipViT is given (the ClipUNet casts them).

Under tensor parallelism (`parallel.tp.shard_params_tp`, which sets a
module's `tp_mesh`) a rank holds H/T heads and F/T hidden units of each
block. The attention runs K3 on the local q/k/v as they are; the local
out_proj partial is summed over the model group in f32 and its bias
added once. The MLP runs K4's TP entry (`fused_mlp_partial`) on the local
fc1/fc2; the f32 partials are summed over the model group and
x + (Σ + b2) is rounded once to the compute dtype, as K4 rounds it.
Without a model axis the blocks are as above.

Pretrained weights travel as the `.npz` that the JAX package's converter
writes (flat '/'-joined flax names, `block_0/attn/q_proj/kernel`, ...;
JAX clip_vit.py:255-342): `hf_vision_npz_arrays` makes that layout from
an HF-layout state dict, and `load_pretrained_clip_state` reads it back
as this module's state dict. One file serves both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_segmentation_tpu_torch.models.convert import _vit
from image_segmentation_tpu_torch.models.layers import lecun_normal_
from image_segmentation_tpu_torch.ops.kernels.attention import (
    attention_reference,
    fused_attention,
)
from image_segmentation_tpu_torch.ops.kernels.mlp import (
    fused_mlp,
    fused_mlp_partial,
    kernel_takes,
    mlp_partial_reference,
    mlp_reference,
)
from image_segmentation_tpu_torch.parallel.tp import copy_to_model, reduce_from_model


@dataclasses.dataclass(frozen=True)
class ClipViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    layer_norm_eps: float = 1e-5

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**2


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics, result in x's dtype (a float64 model
    runs its LayerNorms in f32 too, as the plain MLP does)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(x.dtype)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """nn.Linear computed in x's dtype."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections with bias around softmax(QKᵀ/√d)·V; with
    `tp_mesh` set, this rank's heads (module docstring)."""

    tp_mesh = None

    def __init__(self, cfg: ClipViTConfig, use_kernels: bool):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        h = cfg.hidden_size
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(h, h) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        n, s, _ = x.shape
        head_dim = c.hidden_size // c.num_heads
        if self.tp_mesh is not None:
            x = copy_to_model(x, self.tp_mesh)
        width = self.q_proj.weight.shape[0]  # H, or H / T under TP
        split = lambda t: t.view(n, s, width // head_dim, head_dim)  # noqa: E731
        q, k, v = (split(linear(x, p)) for p in (self.q_proj, self.k_proj, self.v_proj))
        attend = fused_attention if self.use_kernels else attention_reference
        out = attend(q, k, v).reshape(n, s, width)
        if self.tp_mesh is None:
            return linear(out, self.out_proj)
        part = out.float() @ self.out_proj.weight.to(x.dtype).float().t()
        y = reduce_from_model(part, self.tp_mesh) + self.out_proj.bias.to(x.dtype).float()
        return y.to(x.dtype)


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)); x + mlp(ln2(x)); with `tp_mesh` set,
    the MLP over this rank's F/T hidden units (module docstring)."""

    tp_mesh = None

    def __init__(self, cfg: ClipViTConfig, use_kernels: bool):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg, use_kernels)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = ClipMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.use_kernels = use_kernels
        self.fuse_mlp = use_kernels and kernel_takes(cfg.hidden_size, cfg.mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(x, self.layer_norm1))
        ln, fc1, fc2 = self.layer_norm2, self.mlp.fc1, self.mlp.fc2
        if self.tp_mesh is not None:
            return self._mlp_tp(x)
        run_mlp = fused_mlp if self.fuse_mlp else mlp_reference
        return run_mlp(x, ln.weight, ln.bias, fc1.weight.to(x.dtype), fc1.bias,
                       fc2.weight.to(x.dtype), fc2.bias, ln.eps)

    def _mlp_tp(self, x: torch.Tensor) -> torch.Tensor:
        """x + MLP(LN(x)) from this rank's fc1 rows and fc2 columns: K4's TP
        entry where the kernel takes the shapes, the f32 partials summed
        over the model group, then b2 and the residual."""
        ln, fc1, fc2, mesh = self.layer_norm2, self.mlp.fc1, self.mlp.fc2, self.tp_mesh
        fuse = self.use_kernels and kernel_takes(x.shape[-1], fc1.weight.shape[0])
        run = fused_mlp_partial if fuse else mlp_partial_reference
        xi, lw, lb = (copy_to_model(t, mesh) for t in (x, ln.weight, ln.bias))
        part = run(xi, lw, lb, fc1.weight.to(x.dtype), fc1.bias, fc2.weight.to(x.dtype), ln.eps)
        y = reduce_from_model(part, mesh) + fc2.bias.float()
        return x + y.to(x.dtype)


class ClipEncoder(nn.Module):
    def __init__(self, cfg: ClipViTConfig, use_kernels: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(cfg, use_kernels) for _ in range(cfg.num_layers))


class ClipEmbeddings(nn.Module):
    def __init__(self, cfg: ClipViTConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.hidden_size)


class ClipViT(nn.Module):
    """forward(pixels (N, S, S, 3)) → (last_hidden (N, 1+P, H), hidden_states)."""

    def __init__(self, cfg: ClipViTConfig = ClipViTConfig(), use_kernels: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ClipEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = ClipEncoder(cfg, use_kernels)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        c = self.cfg
        n = pixels.shape[0]
        if pixels.shape[1] != c.image_size or pixels.shape[2] != c.image_size:
            raise ValueError(
                f"ClipViT expects {c.image_size}px inputs, got "
                f"{pixels.shape[1]}x{pixels.shape[2]}")
        emb = self.embeddings
        x = pixels.permute(0, 3, 1, 2)  # NHWC → NCHW view
        patches = F.conv2d(x, emb.patch_embedding.weight.to(x.dtype), stride=c.patch_size)
        patches = patches.flatten(2).transpose(1, 2)  # (N, P, H), row-major grid
        cls = emb.class_embedding.to(x.dtype).expand(n, 1, c.hidden_size)
        seq = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight.to(x.dtype)
        seq = layer_norm(seq, self.pre_layrnorm)
        hidden_states = [seq]
        for block in self.encoder.layers:
            seq = block(seq)
            hidden_states.append(seq)
        return seq, hidden_states

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: LeCun-normal kernels, zero biases, unit
        LayerNorms, N(0, 0.02) class and position embeddings."""
        emb = self.embeddings
        emb.class_embedding.normal_(0.0, 0.02, generator=generator)
        emb.position_embedding.weight.normal_(0.0, 0.02, generator=generator)
        lecun_normal_(emb.patch_embedding.weight, emb.patch_embedding.weight[0].numel(),
                      generator)
        for m in self.encoder.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.pre_layrnorm.weight.fill_(1.0)
        self.pre_layrnorm.bias.zero_()


def tokens_to_grid(tokens: torch.Tensor, grid: int) -> torch.Tensor:
    """(N, 1+G², H) → (N, G, G, H): drop CLS, reshape to the grid."""
    return tokens[:, 1:, :].reshape(tokens.shape[0], grid, grid, tokens.shape[-1])


def hf_vision_npz_arrays(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """An HF CLIPVisionModel state dict (tensors or numpy arrays, with or
    without the `vision_model.` prefix) → the flat arrays of the JAX
    converter's `.npz` (JAX `convert_hf_vision_state_dict` then
    `flatten_dict(sep='/')`): linear weights (out, in) → kernel (in, out),
    the patch conv OIHW → HWIO, LayerNorm weight → scale. Other entries
    (position_ids, post_layernorm) are left out, as there."""
    sd = {k.replace("vision_model.", ""): np.asarray(
              v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items()}
    out = {"patch_embedding/kernel":
               sd["embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0),
           "class_embedding": sd["embeddings.class_embedding"],
           "position_embedding": sd["embeddings.position_embedding.weight"],
           "pre_layernorm/scale": sd["pre_layrnorm.weight"],
           "pre_layernorm/bias": sd["pre_layrnorm.bias"]}
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers."))
    for i in range(n_layers):
        src, dst = f"encoder.layers.{i}.", f"block_{i}/"
        for hf, flax in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            out[f"{dst}{flax}/scale"] = sd[f"{src}{hf}.weight"]
            out[f"{dst}{flax}/bias"] = sd[f"{src}{hf}.bias"]
        linears = [(f"self_attn.{n}", f"attn/{n}")
                   for n in ("q_proj", "k_proj", "v_proj", "out_proj")]
        for hf, flax in linears + [("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")]:
            out[f"{dst}{flax}/kernel"] = sd[f"{src}{hf}.weight"].T
            out[f"{dst}{flax}/bias"] = sd[f"{src}{hf}.bias"]
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _vit_state(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The flat '/'-joined arrays of a CLIP `.npz` → the ClipViT state dict."""
    tree: dict = {}
    for key, value in arrays.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return _vit(tree)


def load_pretrained_clip_state(path: str) -> Dict[str, torch.Tensor]:
    """The ClipViT state dict (HF key names, float32) of a converted CLIP
    `.npz`, the file JAX's `load_pretrained_clip_params(cache_path=...)`
    reads."""
    with np.load(path) as npz:
        return _vit_state({key: npz[key] for key in npz.files})


def hf_vision_state(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """An HF CLIPVisionModel state dict → the ClipViT state dict, through
    the `.npz` layout, so both keep exactly the entries the JAX converter
    keeps."""
    return _vit_state(hf_vision_npz_arrays(state_dict))
