"""Segment Anything, ViT-B image encoder: click a point, get the object's mask.

No JAX counterpart: the JAX package's prompt model (models/prompt.py) is
a ClipUNet beside a selection UNet over a click heatmap. This is the
public architecture for the same job, Kirillov et al., "Segment
Anything" (2023), as `segment_anything/build_sam.py` `build_sam_vit_b`
builds it, with its parameter names, so that a converted checkpoint
would load by name:

  * `image_encoder`: a 16 px patch conv and a learned absolute position
    embedding on the (G, G) grid (64 × 64 at 1024 px), 12 pre-norm blocks
    (LayerNorm eps 1e-6) whose attention adds decomposed relative
    positions to its logits, inside 14 × 14 windows of the zero-padded
    map (G padded to a multiple of the window) except at the global
    blocks (2, 5, 8, 11), which attend over all G² tokens; then the neck,
    conv 1×1 → LayerNorm2d → conv 3×3 → LayerNorm2d, to the (N, 256, G, G)
    embedding. The padded tokens are zeros after the first LayerNorm and
    keys like any other (SAM masks nothing). The plain path pads: after
    norm1 it zero-pads, partitions, attends each window and unpartitions
    and crops back; the kernel path does not: it projects qkv over the
    unpadded map and K5's window entry (`window_relpos_attention`) finds
    each window there, the pad keys' k and v being the qkv bias, which
    is what the projection gives a zero token.
  * `prompt_encoder`: random Fourier features of a (2, 128) Gaussian
    matrix for the click, SAM's padding point (no box), and the no-mask
    dense embedding; the image's positional encoding of the grid.
  * `mask_decoder`: the two-way transformer (depth 2, 8 heads, MLP 2,048
    with ReLU, the cross-attentions at internal width 128), the ×4
    transpose-conv upscaling, four hypernetwork MLPs and the IoU head;
    the multimask output (masks 1 to 3 and their IoU predictions).

forward(images (N, S, S, 3) float in [0, 1], clicks (N, 1, 3) float32 as
(x, y, label) in pixels, label 1 positive, 0 negative) → (mask logits
(N, 3, 4G, 4G) f32, IoU predictions (N, 3) f32).

`dtype` is the compute dtype (parameters stay float32; LayerNorm
statistics, the Fourier features and the outputs are f32). With
`use_kernels` the encoder's attention runs K5 (`relpos_attention` at the
global blocks, given q and the block's two relative-position tables;
`window_relpos_attention` at the windowed ones, given the map's q, k, v
and the qkv bias's k and v rows besides) and its MLP half
K4 with the exact GELU (`fused_mlp(..., activation="gelu")`); without,
their plain versions. On CPU tensors the wrappers run the plain versions themselves.
The decoder's attentions (7 tokens, head dim 16 at full width) run on
torch's `scaled_dot_product_attention`. The image encoder is frozen and
runs under `torch.no_grad()` (SAM's fine-tuning recipe), as ClipUNet's
frozen ViT does, so K4 and K5, which have no backward, stay usable in a
train step.

Spans (`utils.profiling.span`): `sam.image_encoder`, `sam.prompt_encoder`
and `sam.mask_decoder` around the three parts of a forward. Counts
(`utils.profiling.count`): `sam.global_attention` and
`sam.window_attention`, one per block call, and `sam.window_pad_tokens`,
the padded tokens a windowed block attends over as keys (804 an image at
1024 px: 70² − 64²; on the kernel path the keys filled from the bias). A
replayed CUDA graph runs no Python, so replays record neither; eager
forwards and captures do.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from image_segmentation_tpu_torch.models.clip_vit import layer_norm, linear
from image_segmentation_tpu_torch.models.layers import lecun_normal_
from image_segmentation_tpu_torch.ops.kernels.mlp import fused_mlp, mlp_reference
from image_segmentation_tpu_torch.ops.kernels.relpos_attention import (
    relpos_attention,
    relpos_attention_reference,
    window_partition,
    window_relpos_attention,
    window_unpartition,
)
from image_segmentation_tpu_torch.utils import profiling

# SAM's pixel normalisation, on 0..255 values
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """`build_sam_vit_b`'s widths; the defaults are the published model."""

    image_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    prompt_embed_dim: int = 256
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    encoder_eps: float = 1e-6
    decoder_eps: float = 1e-5

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


class LayerNorm2d(nn.Module):
    """SAM's LayerNorm2d: the channels of each pixel of an NCHW map
    normalised (biased variance), f32 statistics, result in x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(1, keepdim=True)
        s = (xf - u).square().mean(1, keepdim=True)
        y = (xf - u) / torch.sqrt(s + self.eps)
        return (self.weight[:, None, None] * y + self.bias[:, None, None]).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _pixel_affine(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(255 / std, mean / std) per channel on `device`, made once a device
    (outside inference mode), so that a forward copies nothing from host
    memory and a CUDA graph can capture it (train/graphs.py)."""
    with torch.inference_mode(False):
        std = torch.tensor(PIXEL_STD, dtype=torch.float64)
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float64)
        return ((255.0 / std).float().to(device), (mean / std).float().to(device))


def normalize_pixels(images: torch.Tensor) -> torch.Tensor:
    """(255·x − mean) / std per channel of NHWC [0, 1] images, in f32."""
    scale, shift = _pixel_affine(images.device)
    return images.float() * scale - shift


class EncoderAttention(nn.Module):
    """qkv → heads → softmax(q·kᵀ/√d + rel_h + rel_w)·v → proj, over an
    (B, h, w, C) map; the relative tables are (2·size − 1, head dim)."""

    def __init__(self, dim: int, num_heads: int, size: int, use_kernels: bool):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernels = use_kernels
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        qkv = linear(x, self.qkv).view(b, h * w, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.unbind(2)
        attend = relpos_attention if self.use_kernels else relpos_attention_reference
        out = attend(q, k, v, self.rel_pos_h.to(x.dtype), self.rel_pos_w.to(x.dtype))
        return linear(out.reshape(b, h, w, c), self.proj)

    def windowed(self, x: torch.Tensor, ws: int) -> torch.Tensor:
        """`forward` in each ws × ws window of the (B, h, w, C) map zero-padded
        to multiples of ws, cropped back, by K5's window entry on the
        unpadded map: a pad token's k and v are the qkv bias's rows."""
        b, h, w, c = x.shape
        nh = self.num_heads
        q, k, v = linear(x, self.qkv).view(b, h, w, 3, nh, c // nh).unbind(3)
        bias = self.qkv.bias.to(x.dtype).view(3, nh, c // nh)
        out = window_relpos_attention(q, k, v, bias[1], bias[2], self.rel_pos_h.to(x.dtype),
                                      self.rel_pos_w.to(x.dtype), ws)
        return linear(out.reshape(b, h, w, c), self.proj)


class EncoderMLP(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)


class EncoderBlock(nn.Module):
    """x + attn(LN1(x)) (windowed when `window_size` > 0), then
    x + MLP(LN2(x)) with the exact GELU (K4 with `use_kernels`)."""

    def __init__(self, cfg: SamConfig, window_size: int, use_kernels: bool):
        super().__init__()
        size = window_size if window_size else cfg.grid_size
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.encoder_eps)
        self.attn = EncoderAttention(cfg.embed_dim, cfg.num_heads, size, use_kernels)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.encoder_eps)
        self.mlp = EncoderMLP(cfg.embed_dim, cfg.mlp_dim)
        self.run_mlp = fused_mlp if use_kernels else mlp_reference

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        y = layer_norm(x, self.norm1)
        ws = self.window_size
        if not ws:
            profiling.count("sam.global_attention")
            y = self.attn(y)
        else:
            profiling.count("sam.window_attention")
            profiling.count("sam.window_pad_tokens", n * (-(-h // ws) * -(-w // ws) * ws * ws
                                                          - h * w))
            if self.attn.use_kernels:
                y = self.attn.windowed(y, ws)
            else:
                y, pad_hw = window_partition(y, ws)
                y = window_unpartition(self.attn(y), ws, pad_hw, (h, w))
        x = x + y
        ln, lin1, lin2 = self.norm2, self.mlp.lin1, self.mlp.lin2
        return self.run_mlp(x, ln.weight, ln.bias, lin1.weight.to(x.dtype), lin1.bias,
                       lin2.weight.to(x.dtype), lin2.bias, ln.eps, activation="gelu")


class ImageEncoder(nn.Module):
    """NHWC normalised pixels in the compute dtype → (N, 256, G, G)."""

    def __init__(self, cfg: SamConfig, use_kernels: bool):
        super().__init__()
        self.cfg = cfg
        g, c, out = cfg.grid_size, cfg.embed_dim, cfg.prompt_embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, c, cfg.patch_size, stride=cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, c))
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size,
                         use_kernels) for i in range(cfg.depth))
        self.neck = nn.Sequential(nn.Conv2d(c, out, 1, bias=False),
                                  LayerNorm2d(out, cfg.encoder_eps),
                                  nn.Conv2d(out, out, 3, padding=1, bias=False),
                                  LayerNorm2d(out, cfg.encoder_eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2), proj.weight.to(x.dtype), proj.bias.to(x.dtype),
                     stride=self.cfg.patch_size).permute(0, 2, 3, 1)
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        conv1, ln1, conv2, ln2 = self.neck
        y = F.conv2d(x.permute(0, 3, 1, 2), conv1.weight.to(x.dtype))
        y = F.conv2d(ln1(y), conv2.weight.to(x.dtype), padding=1)
        return ln2(y)


class PositionEmbeddingRandom(nn.Module):
    """Random Fourier features: pe(u) = [sin, cos](2π·(2u − 1)·G) for u in
    [0, 1]² ordered (x, y); G is (2, D/2), a buffer."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        c = (2 * coords.float() - 1) @ self.positional_encoding_gaussian_matrix.float()
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, g: int, device) -> torch.Tensor:
        """(D, g, g): pe of the pixel centres of a g × g grid."""
        centres = (torch.arange(g, device=device, dtype=torch.float32) + 0.5) / g
        y, x = torch.meshgrid(centres, centres, indexing="ij")
        return self.encode(torch.stack([x, y], dim=-1)).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    """One click a prompt → (sparse (N, 2, D): the click and SAM's padding
    point, dense (N, D, G, G): the no-mask embedding); `image_pe()` is the
    grid's positional encoding (1, D, G, G). Four point embeddings
    (SAM's: negative, positive, two box corners) and the not-a-point one.
    SAM's mask-prompt convolutions are left out: no mask prompt is taken."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.embed_dim, self.grid_size, self.image_size = d, cfg.grid_size, cfg.image_size
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def forward(self, clicks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n = clicks.shape[0]
        clicks = clicks.float()
        points = torch.cat([clicks[..., :2] + 0.5, clicks.new_zeros(n, 1, 2)], dim=1)
        labels = torch.cat([clicks[..., 2], clicks.new_full((n, 1), -1.0)], dim=1)[..., None]
        pe = self.pe_layer.encode(points / self.image_size)
        pad = (labels == -1).float()
        sparse = (pe * (1 - pad) + pad * self.not_a_point_embed.weight
                  + (labels == 0).float() * self.point_embeddings[0].weight
                  + (labels == 1).float() * self.point_embeddings[1].weight)
        g = self.grid_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(n, -1, g, g)
        return sparse, dense

    def image_pe(self, device) -> torch.Tensor:
        return self.pe_layer.grid(self.grid_size, device)[None]


class DecoderAttention(nn.Module):
    """Projections to an internal width (D / downsample), heads,
    softmax(q·kᵀ/√d_h)·v by torch's scaled_dot_product_attention, back to D."""

    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        internal = dim // downsample
        self.num_heads = num_heads
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(dim, internal) for _ in range(3))
        self.out_proj = nn.Linear(internal, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        heads = lambda t: t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)  # noqa: E731
        out = F.scaled_dot_product_attention(heads(linear(q, self.q_proj)),
                                             heads(linear(k, self.k_proj)),
                                             heads(linear(v, self.v_proj)))
        return linear(out.transpose(1, 2).flatten(2), self.out_proj)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(torch.relu(linear(x, self.lin1)), self.lin2)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamConfig, skip_first_layer_pe: bool):
        super().__init__()
        d, heads, ds = cfg.prompt_embed_dim, cfg.decoder_num_heads, cfg.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(d, heads)
        self.norm1 = nn.LayerNorm(d, eps=cfg.decoder_eps)
        self.cross_attn_token_to_image = DecoderAttention(d, heads, ds)
        self.norm2 = nn.LayerNorm(d, eps=cfg.decoder_eps)
        self.mlp = MLPBlock(d, cfg.decoder_mlp_dim)
        self.norm3 = nn.LayerNorm(d, eps=cfg.decoder_eps)
        self.norm4 = nn.LayerNorm(d, eps=cfg.decoder_eps)
        self.cross_attn_image_to_token = DecoderAttention(d, heads, ds)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = layer_norm(queries, self.norm1)
        k = keys + key_pe
        queries = layer_norm(
            queries + self.cross_attn_token_to_image(queries + query_pe, k, keys), self.norm2)
        queries = layer_norm(queries + self.mlp(queries), self.norm3)
        keys = keys + self.cross_attn_image_to_token(keys + key_pe, queries + query_pe, queries)
        return queries, layer_norm(keys, self.norm4)


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(cfg, i == 0)
                                    for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(d, cfg.decoder_num_heads,
                                                          cfg.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(d, eps=cfg.decoder_eps)

    def forward(self, image, image_pe, tokens):
        keys = image.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        out = self.final_attn_token_to_image(queries + tokens, keys + key_pe, keys)
        return layer_norm(queries + out, self.norm_final_attn), keys


class MLP(nn.Module):
    """Linear layers with ReLU between them (SAM's mask-decoder MLP)."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = linear(x, lin)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class MaskDecoder(nn.Module):
    """(embedding (N, D, G, G), image pe (1, D, G, G), sparse (N, T, D), dense
    (N, D, G, G)) → (all masks (N, 4, 4G, 4G), all IoU predictions (N, 4)).

    SAM 2's three changes (`sam2/modeling/sam/mask_decoder.py`), off by
    default, which is SAM's decoder: `pred_obj_scores`, an object-score
    token before the IoU token and its head (an MLP of 3 layers, which the
    image path builds and never reads); `iou_sigmoid`, a sigmoid on the
    IoU head; `high_res`, the high-resolution path: given the (N, D, 4G,
    4G) and (N, D, 2G, 2G) levels, the upscaling is
    GELU(LN(dc1(src) + conv_s1(level 2G))), then GELU(dc2(·) +
    conv_s0(level 4G)), with conv_s0 and conv_s1 1 × 1 convs to D/8 and
    D/4."""

    def __init__(self, cfg: SamConfig, pred_obj_scores: bool = False, iou_sigmoid: bool = False,
                 high_res: bool = False):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.pred_obj_scores, self.iou_sigmoid, self.high_res = (pred_obj_scores, iou_sigmoid,
                                                                 high_res)
        if pred_obj_scores:
            self.obj_score_token = nn.Embedding(1, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2), nn.GELU())
        if high_res:
            self.conv_s0 = nn.Conv2d(d, d // 8, 1)
            self.conv_s1 = nn.Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP((d, d, d, d // 8)) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(
            (d,) + (cfg.iou_head_hidden_dim,) * (cfg.iou_head_depth - 1)
            + (self.num_mask_tokens,))
        if pred_obj_scores:
            self.pred_obj_score_head = MLP((d, d, d, 1))

    def forward(self, embedding, image_pe, sparse, dense, high_res_features=None):
        n, d, g, _ = embedding.shape
        dtype = embedding.dtype
        if (high_res_features is not None) != self.high_res:
            raise ValueError("the high-resolution levels are given exactly when the decoder "
                             "is built with high_res")
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        first = 0  # the IoU token's place
        if self.pred_obj_scores:
            out_tokens = torch.cat([self.obj_score_token.weight, out_tokens], dim=0)
            first = 1
        tokens = torch.cat([out_tokens.to(dtype).expand(n, -1, -1), sparse.to(dtype)], dim=1)
        src = embedding + dense.to(dtype)
        hs, src = self.transformer(src, image_pe.to(dtype), tokens)
        src = src.transpose(1, 2).reshape(n, d, g, g)
        up1, ln, _, up2, _ = self.output_upscaling
        y = F.conv_transpose2d(src, up1.weight.to(dtype), up1.bias.to(dtype), stride=2)
        if self.high_res:
            s0, s1 = self.conv_s0, self.conv_s1
            level0, level1 = high_res_features
            y = F.gelu(ln(y + F.conv2d(level1, s1.weight.to(dtype), s1.bias.to(dtype))))
            y = F.gelu(F.conv_transpose2d(y, up2.weight.to(dtype), up2.bias.to(dtype), stride=2)
                       + F.conv2d(level0, s0.weight.to(dtype), s0.bias.to(dtype)))
        else:
            y = F.gelu(ln(y))
            y = F.gelu(F.conv_transpose2d(y, up2.weight.to(dtype), up2.bias.to(dtype), stride=2))
        hyper = torch.stack([mlp(hs[:, first + 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = (hyper @ y.flatten(2)).view(n, -1, y.shape[2], y.shape[3])
        iou = self.iou_prediction_head(hs[:, first])
        return masks, torch.sigmoid(iou) if self.iou_sigmoid else iou


class SamViTB(nn.Module):
    """forward(images (N, S, S, 3), clicks (N, 1, 3)) → (mask logits (N, 3,
    4G, 4G) f32, IoU (N, 3) f32) (module docstring)."""

    def __init__(self, sam: SamConfig = SamConfig(), dtype: torch.dtype = torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        self.cfg = cfg = sam
        self.dtype = dtype
        self.image_encoder = ImageEncoder(cfg, use_kernels)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def forward(self, images: torch.Tensor, clicks: torch.Tensor):
        s = self.cfg.image_size
        if images.shape[1:] != (s, s, 3):
            raise ValueError(f"SamViTB expects (N, {s}, {s}, 3) images, got {tuple(images.shape)}")
        with profiling.span("sam.image_encoder"):
            with torch.no_grad():
                embedding = self.image_encoder(normalize_pixels(images).to(self.dtype))
        with profiling.span("sam.prompt_encoder"):
            sparse, dense = self.prompt_encoder(clicks)
            image_pe = self.prompt_encoder.image_pe(images.device)
        with profiling.span("sam.mask_decoder"):
            masks, iou = self.mask_decoder(embedding, image_pe, sparse, dense)
        return masks[:, 1:].float(), iou[:, 1:].float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SamViTB":
        """Random init from `generator`: LeCun-normal kernels (a transpose
        conv's fan-in is its input channels), zero biases, unit norms,
        N(0, 0.02) position embedding and relative tables (SAM zeroes both
        before loading its checkpoint; random ones exercise the terms),
        N(0, 1) token embeddings and Fourier matrix (SAM's)."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
                p.normal_(0.0, 0.02, generator=generator)
            elif name.endswith("embed.weight") or ".point_embeddings." in name or (
                    name.endswith(("iou_token.weight", "mask_tokens.weight"))):
                p.normal_(0.0, 1.0, generator=generator)
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:  # LayerNorm weights
                p.fill_(1.0)
            else:
                fan_in = p.shape[0] if ".output_upscaling." in name else p[0].numel()
                lecun_normal_(p, fan_in, generator)
        self.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(
            0.0, 1.0, generator=generator)
        return self
