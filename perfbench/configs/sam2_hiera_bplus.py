"""SAM 2.1 Hiera-B+ at 1024 px (`sam2.1_hiera_b+.yaml`), its image encoder
(the Hiera trunk and FPN neck) frozen and its prompt encoder, mask decoder
and `no_mem_embed` trained on one click an image. The served model is the
port's `Sam2HieraBPlus` as `config.MODELS` builds it; beside it the plain
reference (`perfbench/reference/sam2.py`), the seeded weights, the
analytic FLOP counts and K5's operations and bytes per call."""
from __future__ import annotations

import math

import torch

from perfbench import counts, harness
from perfbench.reference.sam2 import Sam2 as ReferenceSam2
from perfbench.reference.sam2 import block_specs

FROZEN = ("image_encoder",)
# windows of at most this many keys run SDPA in the port, not K5
# (models/hiera.py SMALL_WINDOW_KEYS)
SMALL_WINDOW_KEYS = 16


def _widths(cfg: dict) -> dict:
    """The configuration's arguments under the names the reference takes."""
    if cfg["mlp_act"] != "gelu" or cfg["decoder_mlp_act"] != "relu":
        raise ValueError("only Hiera's GELU MLP and the decoder's ReLU MLP are built")
    if cfg["fpn_interp_model"] != "nearest" or cfg["fuse_type"] != "sum":
        raise ValueError("only the neck's nearest top-down sum is built")
    flags = ("use_high_res_features_in_sam", "pred_obj_scores", "pred_obj_scores_mlp",
             "iou_prediction_use_sigmoid", "directly_add_no_mem_embed", "qkv_bias")
    if not all(cfg[f] for f in flags) or cfg["num_point_embeddings"] != 4:
        raise ValueError(f"only SAM 2.1 B+'s image path ({', '.join(flags)}) is built")
    if cfg["backbone_channel_list"] != channel_list(cfg):
        raise ValueError("backbone_channel_list is not the trunk's stage widths")
    if cfg["num_pos_feats"] * 2 != cfg["prompt_embed_dim"] or cfg["d_model"] != cfg[
            "prompt_embed_dim"]:
        raise ValueError("the neck, the Fourier features and the decoder disagree on width")
    return dict(image_size=cfg["image_size"], embed_dim=cfg["embed_dim"],
                num_heads=cfg["num_heads"], stages=tuple(cfg["stages"]), q_pool=cfg["q_pool"],
                q_stride=cfg["q_stride"][0], window_spec=tuple(cfg["window_spec"]),
                global_att_blocks=tuple(cfg["global_att_blocks"]),
                window_pos_embed_bkg_spatial_size=tuple(
                    cfg["window_pos_embed_bkg_spatial_size"]),
                mlp_ratio=cfg["mlp_ratio"], patch_kernel=cfg["patch_kernel_size"],
                patch_stride=cfg["patch_stride"], patch_padding=cfg["patch_padding"],
                d_model=cfg["d_model"], fpn_top_down_levels=tuple(cfg["fpn_top_down_levels"]),
                scalp=cfg["scalp"], decoder_depth=cfg["decoder_depth"],
                decoder_num_heads=cfg["decoder_num_heads"],
                decoder_mlp_dim=cfg["decoder_mlp_dim"],
                attention_downsample_rate=cfg["attention_downsample_rate"],
                num_multimask_outputs=cfg["num_multimask_outputs"],
                iou_head_depth=cfg["iou_head_depth"],
                iou_head_hidden_dim=cfg["iou_head_hidden_dim"],
                encoder_eps=cfg["encoder_layer_norm_eps"],
                decoder_eps=cfg["decoder_layer_norm_eps"])


def _specs(cfg: dict) -> list:
    return block_specs(cfg["embed_dim"], cfg["num_heads"], cfg["stages"], cfg["q_pool"],
                       cfg["window_spec"], cfg["global_att_blocks"], cfg["dim_mul"],
                       cfg["head_mul"])


def channel_list(cfg: dict) -> list:
    """The trunk's stage widths, coarsest first."""
    specs, ends = _specs(cfg), [sum(cfg["stages"][:i]) - 1
                                for i in range(1, len(cfg["stages"]) + 1)]
    return [specs[i]["dim_out"] for i in ends[::-1]]


def port(cfg: dict, device) -> torch.nn.Module:
    """The port's Sam2HieraBPlus (the configuration's compute dtype and K5 on
    a card, float32 on the CPU), frozen encoder, without its initialisation."""
    from image_segmentation_tpu_torch import config
    from image_segmentation_tpu_torch.models import hiera, sam, sam2

    if (sam.PIXEL_MEAN, sam.PIXEL_STD) != (tuple(cfg["pixel_mean"]), tuple(cfg["pixel_std"])):
        raise ValueError("the port's pixel normalisation is not the configuration's")
    w = _widths(cfg)
    trunk = hiera.HieraConfig(
        embed_dim=w["embed_dim"], num_heads=w["num_heads"], stages=w["stages"],
        q_pool=w["q_pool"], q_stride=w["q_stride"], dim_mul=cfg["dim_mul"],
        head_mul=cfg["head_mul"],
        window_pos_embed_bkg_spatial_size=w["window_pos_embed_bkg_spatial_size"],
        window_spec=w["window_spec"], global_att_blocks=w["global_att_blocks"],
        mlp_ratio=w["mlp_ratio"], eps=w["encoder_eps"], patch_kernel=w["patch_kernel"],
        patch_stride=w["patch_stride"], patch_padding=w["patch_padding"],
        d_model=w["d_model"], fpn_top_down_levels=w["fpn_top_down_levels"], scalp=w["scalp"])
    decoder = sam.SamConfig(
        prompt_embed_dim=cfg["prompt_embed_dim"],
        decoder_depth=w["decoder_depth"], decoder_num_heads=w["decoder_num_heads"],
        decoder_mlp_dim=w["decoder_mlp_dim"],
        attention_downsample_rate=w["attention_downsample_rate"],
        num_multimask_outputs=w["num_multimask_outputs"], iou_head_depth=w["iou_head_depth"],
        iou_head_hidden_dim=w["iou_head_hidden_dim"], decoder_eps=w["decoder_eps"])
    cls, _ = config.MODELS["sam2_hiera_bplus"]
    cuda = torch.device(device).type == "cuda"
    with torch.device("meta"):
        model = cls(sam2=sam2.Sam2Config(image_size=w["image_size"], hiera=trunk,
                                         decoder=decoder),
                    dtype=harness.compute_dtype(cfg) if cuda else torch.float32,
                    use_kernels=cuda)
    return model.to_empty(device=device)


def reference(cfg: dict, ops=None) -> torch.nn.Module:
    with torch.device("meta"):
        return ReferenceSam2(**_widths(cfg), ops=ops)


def init_spec(name: str, shape) -> tuple:
    """(centre, half width) of the uniform draw for one leaf: LeCun's
    variance for kernels (a transpose conv's fan-in is its input
    channels), N(0, 1)'s for the token embeddings and the Fourier matrix,
    0.02's for the two position embeddings and `no_mem_embed` (SAM 2
    zero-initialises them), LayerNorm scales 1 ± 0.1, biases (LayerNorms'
    too) ± 0.05."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("pos_embed", "pos_embed_window", "no_mem_embed"):
        return 0.0, 0.02 * math.sqrt(3.0)
    if leaf == "positional_encoding_gaussian_matrix" or name.endswith(
            ("embed.weight", "_token.weight", "mask_tokens.weight")) or (
            ".point_embeddings." in name):
        return 0.0, math.sqrt(3.0)
    if len(shape) == 1:
        norm = "norm" in name or ".output_upscaling.1." in name
        return (1.0, 0.1) if norm and leaf == "weight" else (0.0, 0.05)
    fan_in = shape[0] if ".output_upscaling." in name else math.prod(shape[1:])
    return 0.0, math.sqrt(3.0 / fan_in)


# -- the arithmetic -------------------------------------------------------------

def _padded(g: int, ws: int) -> int:
    return -(-g // ws) * ws


def _maps(cfg: dict) -> list:
    """(block spec, side of the map it attends, side of its output, whether
    its output is a trunk level) of each trunk block."""
    side, stride = cfg["image_size"] // cfg["patch_stride"], cfg["q_stride"][0]
    ends = {sum(cfg["stages"][:i]) - 1 for i in range(1, len(cfg["stages"]) + 1)}
    out = []
    for i, spec in enumerate(_specs(cfg)):
        after = side // stride if spec["pool"] else side
        out.append((spec, side, after, i in ends))
        side = after
    return out


def k5_counts(tokens: int, keys: int, heads: int, d: int) -> tuple:
    """K5 without tables, softmax(q·kᵀ/√d)·v for `tokens` queries of `keys`
    keys each, `heads` heads of d (bf16): (FLOPs, bytes). The real work at
    d: the kernel's tiles are 64 wide, but columns past d are zeros it
    needs not; q, k and v read once and the output written once (a window
    map's pad keys are the bias, read from no map)."""
    return 4 * tokens * keys * heads * d, counts.BF16 * 4 * tokens * heads * d


def k5_calls(cfg: dict, n: int) -> list:
    """(tokens, keys, heads, d) of each K5 call of one forward of n images,
    in block order: the windowed blocks (but the pooled ones and those whose
    windows hold at most SMALL_WINDOW_KEYS keys, which run SDPA) over the
    map's real queries, each with its window's keys, the pad's among them;
    the global blocks over the whole map."""
    calls = []
    for spec, side, _, _ in _maps(cfg):
        ws, heads = spec["window"], spec["heads"]
        if spec["pool"] or 0 < ws * ws <= SMALL_WINDOW_KEYS:
            continue
        keys = ws * ws if ws else side * side
        calls.append((n * side * side, keys, heads, spec["dim_out"] // heads))
    return calls


def k5_bound_s(cfg: dict, n: int) -> float:
    """The sum of the bounds of one forward's K5 calls at n images."""
    return sum(counts.bound_s(*k5_counts(*call))[0] for call in k5_calls(cfg, n))


def encoder_flops(cfg: dict) -> float:
    """The image encoder's products for one image: the patch conv; each
    block's qkv over the tokens it attends (a windowed block's padded map,
    as `sam_vitb.py` counts them), its attention over the padded windows
    (a pooled block's pooled queries against its window's keys), its proj
    over the queries, its shortcut projection, its MLP over its output
    map; the neck's 1 × 1 laterals."""
    stride, k = cfg["q_stride"][0], cfg["patch_kernel_size"]
    side = cfg["image_size"] // cfg["patch_stride"]
    total = counts.conv_flops(side * side, 3, cfg["embed_dim"], k)
    for spec, g, out, level in _maps(cfg):
        ws, c, c_out = spec["window"], spec["dim"], spec["dim_out"]
        tokens = _padded(g, ws) ** 2 if ws else g * g
        keys = ws * ws if ws else g * g
        queries = tokens // (stride * stride) if spec["pool"] else tokens
        total += 2 * tokens * c * 3 * c_out + 2 * queries * c_out * c_out  # qkv, proj
        total += 4 * queries * keys * c_out  # q·kᵀ and p·v over every head
        if c != c_out:
            total += 2 * g * g * c * c_out  # the shortcut's projection
        total += 4 * out * out * c_out * int(cfg["mlp_ratio"] * c_out)
        if level:
            total += counts.conv_flops(out * out, c_out, cfg["d_model"], 1)
    return total


def decoder_flops(cfg: dict) -> float:
    """The image path's trained products for one image and one click (8
    tokens: the object score, IoU, 4 mask, the click, the padding point):
    the two-way transformer, the final attention, the ×4 upscaling with
    `conv_s1` and `conv_s0` on the finer levels, the hypernetwork and IoU
    MLPs and the masks; the object-score head is not run."""
    g = cfg["image_size"] // (cfg["patch_stride"] * cfg["q_stride"][0] ** (
        len(cfg["stages"]) - 1 - cfg["scalp"]))
    d = cfg["prompt_embed_dim"]
    inner = d // cfg["attention_downsample_rate"]
    k = cfg["num_multimask_outputs"] + 1
    keys, t = g * g, 1 + 1 + k + 2

    def attn(nq, nk, width):  # projections, q·kᵀ and p·v
        return 2 * (nq * d * width + 2 * nk * d * width + nq * width * d) + 4 * nq * nk * width

    layer = (attn(t, t, d) + attn(t, keys, inner) + 4 * t * d * cfg["decoder_mlp_dim"]
             + attn(keys, t, inner))
    up = counts.conv_flops(keys, d, d // 4, 2) + counts.conv_flops(4 * keys, d // 4, d // 8, 2)
    high_res = (counts.conv_flops(4 * keys, d, d // 4, 1)
                + counts.conv_flops(16 * keys, d, d // 8, 1))
    h = cfg["iou_head_hidden_dim"]
    mlps = k * 2 * (2 * d * d + d * d // 8) + 2 * (d * h + h * h + h * k)
    masks = 2 * k * (d // 8) * 16 * keys
    return (cfg["decoder_depth"] * layer + attn(t, keys, inner) + up + high_res + mlps
            + masks)


def forward_flops(cfg: dict) -> float:
    return encoder_flops(cfg) + decoder_flops(cfg)


def train_flops(cfg: dict) -> float:
    """The frozen encoder's forward, the decoder's forward and its backward
    (its weights' gradients and its inputs', as in `sam_vitb.py`): three
    times its forward."""
    return encoder_flops(cfg) + 3 * decoder_flops(cfg)
