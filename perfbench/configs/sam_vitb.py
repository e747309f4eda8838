"""Segment Anything ViT-B at 1024 px (`build_sam_vit_b`), its image encoder
frozen and its prompt encoder and mask decoder trained on one click an
image. The served model is the port's `SamViTB` as `config.MODELS`
builds it; beside it the plain reference (`perfbench/reference/sam.py`),
the seeded weights, the analytic FLOP counts and K5's operations and
bytes per call."""
from __future__ import annotations

import math

import torch

from perfbench import counts, harness
from perfbench.reference.sam import Sam as ReferenceSam

FROZEN = ("image_encoder",)


def _widths(cfg: dict) -> dict:
    """The configuration's widths under the names both models take."""
    if cfg["mlp_act"] != "gelu" or cfg["decoder_mlp_act"] != "relu":
        raise ValueError("only SAM's GELU encoder MLP and ReLU decoder MLP are built")
    if cfg["encoder_mlp_dim"] != cfg["mlp_ratio"] * cfg["encoder_embed_dim"]:
        raise ValueError("encoder_mlp_dim is not mlp_ratio x encoder_embed_dim")
    if cfg["image_size"] // cfg["vit_patch_size"] != cfg["image_embedding_size"]:
        raise ValueError("image_embedding_size is not image_size / vit_patch_size")
    if cfg["num_pos_feats"] * 2 != cfg["prompt_embed_dim"]:
        raise ValueError("num_pos_feats is not half of prompt_embed_dim")
    if not (cfg["qkv_bias"] and cfg["use_rel_pos"]) or cfg["num_point_embeddings"] != 4:
        raise ValueError("only SAM's qkv bias, relative positions and 4 point embeddings "
                         "are built")
    return dict(image_size=cfg["image_size"], patch_size=cfg["vit_patch_size"],
                embed_dim=cfg["encoder_embed_dim"], depth=cfg["encoder_depth"],
                num_heads=cfg["encoder_num_heads"], mlp_dim=cfg["encoder_mlp_dim"],
                window_size=cfg["window_size"],
                global_attn_indexes=tuple(cfg["encoder_global_attn_indexes"]),
                prompt_embed_dim=cfg["prompt_embed_dim"], decoder_depth=cfg["decoder_depth"],
                decoder_num_heads=cfg["decoder_num_heads"],
                decoder_mlp_dim=cfg["decoder_mlp_dim"],
                attention_downsample_rate=cfg["attention_downsample_rate"],
                num_multimask_outputs=cfg["num_multimask_outputs"],
                iou_head_depth=cfg["iou_head_depth"],
                iou_head_hidden_dim=cfg["iou_head_hidden_dim"],
                encoder_eps=cfg["encoder_layer_norm_eps"],
                decoder_eps=cfg["decoder_layer_norm_eps"])


def port(cfg: dict, device) -> torch.nn.Module:
    """The port's SamViTB (the configuration's compute dtype and K4/K5 on a
    card, float32 on the CPU), frozen encoder, without its initialisation."""
    from image_segmentation_tpu_torch import config
    from image_segmentation_tpu_torch.models import sam

    if (sam.PIXEL_MEAN, sam.PIXEL_STD) != (tuple(cfg["pixel_mean"]), tuple(cfg["pixel_std"])):
        raise ValueError("the port's pixel normalisation is not the configuration's")
    cls, _ = config.MODELS["sam_vitb"]
    cuda = torch.device(device).type == "cuda"
    with torch.device("meta"):
        model = cls(sam=sam.SamConfig(**_widths(cfg)),
                    dtype=harness.compute_dtype(cfg) if cuda else torch.float32,
                    use_kernels=cuda)
    return model.to_empty(device=device)


def reference(cfg: dict, ops=None) -> torch.nn.Module:
    with torch.device("meta"):
        return ReferenceSam(**_widths(cfg), ops=ops)


def init_spec(name: str, shape) -> tuple:
    """(centre, half width) of the uniform draw for one leaf: LeCun's
    variance for kernels (a transpose conv's fan-in is its input
    channels), N(0, 1)'s for the token embeddings and the Fourier matrix,
    0.02's for the position embedding and 0.1's for the relative tables
    (their terms then move the logits by about one), LayerNorm scales
    1 ± 0.1, biases (LayerNorms' too) ± 0.05."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "pos_embed":
        return 0.0, 0.02 * math.sqrt(3.0)
    if leaf in ("rel_pos_h", "rel_pos_w"):
        return 0.0, 0.1 * math.sqrt(3.0)
    if leaf == "positional_encoding_gaussian_matrix" or name.endswith(
            ("embed.weight", "iou_token.weight", "mask_tokens.weight")) or (
            ".point_embeddings." in name):
        return 0.0, math.sqrt(3.0)
    if len(shape) == 1:
        norm = "norm" in name or ".neck." in name or ".output_upscaling.1." in name
        return (1.0, 0.1) if norm and leaf == "weight" else (0.0, 0.05)
    fan_in = shape[0] if ".output_upscaling." in name else math.prod(shape[1:])
    return 0.0, math.sqrt(3.0 / fan_in)


# -- the arithmetic -------------------------------------------------------------

def k5_counts(bp: int, s: int, heads: int, d: int, h: int, w: int) -> tuple:
    """K5, softmax(q·kᵀ/√d + rel_h + rel_w)·v on (B', S, heads, d) bf16 over
    an h × w map: (FLOPs, bytes). The kernel makes the relative terms from
    q and the (2h − 1, d), (2w − 1, d) tables, so their S·(h + w) dot
    products count; q, k, v and the tables are read once and the output
    written once."""
    flops = 4 * bp * heads * s * s * d + 2 * bp * heads * s * (h + w) * d
    nbytes = counts.BF16 * (4 * bp * s * heads * d + (2 * h - 1 + 2 * w - 1) * d)
    return flops, nbytes


def _padded(g: int, ws: int) -> int:
    return -(-g // ws) * ws


def k5_calls(cfg: dict, n: int) -> list:
    """(B', S, heads, d, h, w) of each K5 call of one forward of n images, in
    block order: windowed blocks over the padded map's windows, global
    blocks over the whole grid."""
    g, ws, heads = cfg["image_embedding_size"], cfg["window_size"], cfg["encoder_num_heads"]
    d = cfg["encoder_embed_dim"] // heads
    windows = (_padded(g, ws) // ws) ** 2
    return [(n, g * g, heads, d, g, g) if i in cfg["encoder_global_attn_indexes"]
            else (n * windows, ws * ws, heads, d, ws, ws) for i in range(cfg["encoder_depth"])]


def k5_bound_s(cfg: dict, n: int) -> float:
    """The sum of the bounds of one forward's K5 calls at n images."""
    return sum(counts.bound_s(*k5_counts(*call))[0] for call in k5_calls(cfg, n))


def encoder_flops(cfg: dict) -> float:
    """The image encoder's products for one image: the patch conv, each
    block's qkv and proj over the tokens it attends (the padded map at
    windowed blocks), the attention's products with the relative terms',
    the MLP over the grid, and the neck's convs."""
    g, c, f = cfg["image_embedding_size"], cfg["encoder_embed_dim"], cfg["encoder_mlp_dim"]
    out = cfg["prompt_embed_dim"]
    total = counts.conv_flops(g * g, 3, c, cfg["vit_patch_size"])
    for bp, s, heads, d, h, w in k5_calls(cfg, 1):
        tokens = bp * s
        total += 2 * tokens * c * 3 * c + 2 * tokens * c * c
        total += 4 * bp * heads * s * s * d + 2 * bp * heads * s * (h + w) * d  # attention
        total += 4 * g * g * c * f
    return total + counts.conv_flops(g * g, c, out, 1) + counts.conv_flops(g * g, out, out, 3)


def decoder_flops(cfg: dict) -> float:
    """The mask decoder's products for one image and one click (7 tokens:
    IoU, 4 mask, the click, the padding point)."""
    g, d = cfg["image_embedding_size"], cfg["prompt_embed_dim"]
    inner = d // cfg["attention_downsample_rate"]
    keys, t = g * g, 1 + (cfg["num_multimask_outputs"] + 1) + 2

    def attn(nq, nk, width):  # projections, q·kᵀ and p·v
        return 2 * (nq * d * width + 2 * nk * d * width + nq * width * d) + 4 * nq * nk * width

    layer = (attn(t, t, d) + attn(t, keys, inner) + 4 * t * d * cfg["decoder_mlp_dim"]
             + attn(keys, t, inner))
    k = cfg["num_multimask_outputs"] + 1
    up = counts.conv_flops(keys, d, d // 4, 2) + counts.conv_flops(4 * keys, d // 4, d // 8, 2)
    mlps = k * 2 * (2 * d * d + d * d // 8) + 2 * (d * cfg["iou_head_hidden_dim"]
                                                   + cfg["iou_head_hidden_dim"] ** 2
                                                   + cfg["iou_head_hidden_dim"] * k)
    masks = 2 * k * (d // 8) * 16 * keys
    return cfg["decoder_depth"] * layer + attn(t, keys, inner) + up + mlps + masks


def forward_flops(cfg: dict) -> float:
    return encoder_flops(cfg) + decoder_flops(cfg)


def train_flops(cfg: dict) -> float:
    """The frozen encoder's forward, the decoder's forward and its backward:
    every decoder product computes its weights' gradient and its inputs'
    (the image tokens carry one from the trained no-mask embedding), so
    three times its forward."""
    return encoder_flops(cfg) + 3 * decoder_flops(cfg)
