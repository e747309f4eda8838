"""The benchmark's plain reference of SAM 2.1 Hiera-B+ on images (Ravi et al.
2024; `facebookresearch/sam2`, `sam2/configs/sam2.1/sam2.1_hiera_b+.yaml`):
the forward, the fine-tuning loss and, through autograd, the gradients, in
float32 plain PyTorch. It imports neither the JAX package nor its port,
and no kernel; `ops.fp32_context` turns TF32 off for its products and
convolutions, whose rounding `ops.Ops` owns (the float8 control rounds
them).

Written from SAM 2's published code, each part where it lives there:
  * trunk, `sam2/modeling/backbones/hieradet.py` (`Hiera`,
    `MultiScaleBlock`, `MultiScaleAttention`, `do_pool`) and
    `backbones/utils.py` (`PatchEmbed`, `window_partition`,
    `window_unpartition`): the 7 × 7 stride-4 patch conv, the bicubic
    `pos_embed` plus the tiled `pos_embed_window`, and the blocks as the
    constructor lays them out, with padding, partition, q-pooling,
    unpartition and crop literal;
  * neck, `backbones/image_encoder.py` (`FpnNeck`, `ImageEncoder`): 1 × 1
    laterals, the nearest top-down path at levels 2 and 3 in float32,
    scalp 1;
  * image path, `sam2/modeling/sam2_base.py` `forward_image` (`conv_s0`
    and `conv_s1` on the two finer levels) and
    `sam2/sam2_image_predictor.py` `set_image` (+ `no_mem_embed`) and
    `_predict` (multimask output);
  * mask decoder, `sam2/modeling/sam/mask_decoder.py` `predict_masks`: the
    object-score token before the IoU token, the high-resolution
    upscaling, the sigmoid IoU head; its two-way transformer and the
    prompt encoder are SAM's, as `perfbench/reference/sam.py` computes
    them (`Sam._attend`, `Sam._mlp`, `Sam.prompts`, borrowed here).

Departures from the published code:
  * the attention is written out, softmax((q·d^-½)·kᵀ)·v, where SAM 2
    calls `F.scaled_dot_product_attention`; a global block's is computed
    in blocks of `head_chunk` heads so that a 1024 px image fits;
  * the neck's sine position encodings, which the image path never reads,
    and the video path are not computed; `PromptEncoder`'s mask-prompt
    convolutions are not built (no mask prompt is given);
  * the parameters carry the port's names (models/sam2.py), which are SAM
    2's but for the two-way transformer's MLPs (`mlp.lin1`, `mlp.lin2`,
    SAM's names, where SAM 2 has `mlp.layers.0` and `mlp.layers.1`);
  * the object-score head is built and not run: the image path reads
    nothing from it.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.ops import Ops, fp32_context
from perfbench.reference.sam import PIXEL_MEAN, PIXEL_STD, Norm, Sam, _lin, gelu, layer_norm


def window_partition(x: torch.Tensor, ws: int):
    """backbones/utils.py: (B, H, W, C) → (B·nh·nw, ws, ws, C) windows of the
    map zero-padded to multiples of ws, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


def do_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """hieradet's `do_pool` with nn.MaxPool2d(stride, stride, ceil_mode=False)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


def block_specs(embed_dim, num_heads, stages, q_pool, window_spec, global_att_blocks,
                dim_mul=2.0, head_mul=2.0) -> List[dict]:
    """`Hiera.__init__`'s loop: each block's dim, dim_out, heads, window and
    whether it pools q (the first block of a stage lags a block: it takes
    the previous stage's window and the new stage's width and heads)."""
    stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    q_pool_blocks = [x + 1 for x in stage_ends[:-1]][:q_pool]
    out, cur_stage = [], 1
    for i in range(sum(stages)):
        dim_out = embed_dim
        window_size = window_spec[cur_stage - 1]
        window_size = 0 if i in global_att_blocks else window_size
        if i - 1 in stage_ends:
            dim_out = int(embed_dim * dim_mul)
            num_heads = int(num_heads * head_mul)
            cur_stage += 1
        out.append(dict(dim=embed_dim, dim_out=dim_out, heads=num_heads, window=window_size,
                        pool=i in q_pool_blocks))
        embed_dim = dim_out
    return out


class Sam2(nn.Module):
    """forward(images (N, S, S, 3) in [0, 1], clicks (N, 1, 3)) → (masks
    (N, 3, S/4, S/4), IoU (N, 3)); the arguments as the yaml and hieradet
    name them."""

    # SAM's two-way transformer attention, its MLPs and prompt encoder
    _attend, _mlp, _pe, prompts = Sam._attend, Sam._mlp, Sam._pe, Sam.prompts

    def __init__(self, image_size=1024, embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
                 q_pool=3, q_stride=2, window_spec=(8, 4, 14, 7),
                 global_att_blocks=(12, 16, 20), window_pos_embed_bkg_spatial_size=(14, 14),
                 mlp_ratio=4.0, patch_kernel=7, patch_stride=4, patch_padding=3, d_model=256,
                 fpn_top_down_levels=(2, 3), scalp=1, decoder_depth=2, decoder_num_heads=8,
                 decoder_mlp_dim=2048, attention_downsample_rate=2, num_multimask_outputs=3,
                 iou_head_depth=3, iou_head_hidden_dim=256, encoder_eps=1e-6, decoder_eps=1e-5,
                 ops=None, head_chunk: int = 4):
        super().__init__()
        self.ops = ops or Ops()
        self.image_size, self.q_stride, self.head_chunk = image_size, q_stride, head_chunk
        self.patch_stride, self.patch_padding = patch_stride, patch_padding
        self.stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
        self.fpn_top_down_levels, self.scalp = tuple(fpn_top_down_levels), scalp
        self.enc_eps, self.dec_eps, self.dec_heads = encoder_eps, decoder_eps, decoder_num_heads
        # the image embedding: the coarsest kept level, stride patch · q_stride^(levels − 1)
        self.g = image_size // (patch_stride * q_stride ** (len(stages) - 1 - scalp))
        self.specs = block_specs(embed_dim, num_heads, stages, q_pool, window_spec,
                                 global_att_blocks)
        d = d_model
        enc = self.image_encoder = nn.Module()
        trunk = enc.trunk = nn.Module()
        trunk.patch_embed = nn.Module()
        trunk.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_kernel, stride=patch_stride,
                                           padding=patch_padding)
        trunk.pos_embed = nn.Parameter(torch.empty(1, embed_dim,
                                                   *window_pos_embed_bkg_spatial_size))
        trunk.pos_embed_window = nn.Parameter(torch.empty(1, embed_dim, window_spec[0],
                                                          window_spec[0]))
        blocks = []
        for s in self.specs:
            blk = nn.Module()
            blk.norm1 = Norm(s["dim"])
            blk.attn = nn.Module()
            blk.attn.qkv, blk.attn.proj = _lin(s["dim"], 3 * s["dim_out"]), _lin(s["dim_out"],
                                                                                s["dim_out"])
            blk.norm2 = Norm(s["dim_out"])
            blk.mlp = nn.Module()
            hidden = int(s["dim_out"] * mlp_ratio)
            blk.mlp.layers = nn.ModuleList([_lin(s["dim_out"], hidden),
                                            _lin(hidden, s["dim_out"])])
            if s["dim"] != s["dim_out"]:
                blk.proj = _lin(s["dim"], s["dim_out"])
            blocks.append(blk)
        trunk.blocks = nn.ModuleList(blocks)
        enc.neck = nn.Module()
        widths = [self.specs[i]["dim_out"] for i in self.stage_ends[::-1]]
        enc.neck.convs = nn.ModuleList()
        for dim in widths:
            conv = nn.Module()
            conv.conv = nn.Conv2d(dim, d, 1)
            enc.neck.convs.append(conv)

        pe = self.sam_prompt_encoder = nn.Module()
        pe.pe_layer = nn.Module()
        pe.pe_layer.register_buffer("positional_encoding_gaussian_matrix",
                                    torch.empty(2, d // 2))
        pe.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        pe.not_a_point_embed, pe.no_mask_embed = nn.Embedding(1, d), nn.Embedding(1, d)

        dec = self.sam_mask_decoder = nn.Module()
        dec.transformer = nn.Module()
        inner = d // attention_downsample_rate

        def attention(width):
            a = nn.Module()
            a.q_proj, a.k_proj, a.v_proj = _lin(d, width), _lin(d, width), _lin(d, width)
            a.out_proj = _lin(width, d)
            return a

        layers = []
        for _ in range(decoder_depth):
            layer = nn.Module()
            layer.self_attn = attention(d)
            layer.cross_attn_token_to_image = attention(inner)
            layer.cross_attn_image_to_token = attention(inner)
            layer.mlp = nn.Module()
            layer.mlp.lin1, layer.mlp.lin2 = _lin(d, decoder_mlp_dim), _lin(decoder_mlp_dim, d)
            for i in range(1, 5):
                setattr(layer, f"norm{i}", Norm(d))
            layers.append(layer)
        dec.transformer.layers = nn.ModuleList(layers)
        dec.transformer.final_attn_token_to_image = attention(inner)
        dec.transformer.norm_final_attn = Norm(d)
        k = num_multimask_outputs + 1
        dec.iou_token, dec.mask_tokens = nn.Embedding(1, d), nn.Embedding(k, d)
        dec.obj_score_token = nn.Embedding(1, d)
        dec.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), Norm(d // 4), nn.Identity(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2))
        dec.conv_s0, dec.conv_s1 = nn.Conv2d(d, d // 8, 1), nn.Conv2d(d, d // 4, 1)

        def mlp(dims):
            m = nn.Module()
            m.layers = nn.ModuleList(_lin(a, b) for a, b in zip(dims[:-1], dims[1:]))
            return m

        dec.output_hypernetworks_mlps = nn.ModuleList(mlp((d, d, d, d // 8)) for _ in range(k))
        dec.iou_prediction_head = mlp((d,) + (iou_head_hidden_dim,) * (iou_head_depth - 1)
                                      + (k,))
        dec.pred_obj_score_head = mlp((d, d, d, 1))
        self.no_mem_embed = nn.Parameter(torch.empty(1, 1, d))

    @property
    def prompt_encoder(self) -> nn.Module:  # the name `Sam.prompts` reads
        return self.sam_prompt_encoder

    # -- trunk ------------------------------------------------------------------

    def _attention(self, blk: nn.Module, heads: int, x: torch.Tensor, pool: bool):
        """MultiScaleAttention.forward on (B, H, W, dim) windows or a map."""
        o, a = self.ops, blk.attn
        b, h, w, _ = x.shape
        qkv = o.linear(x, a.qkv.weight, a.qkv.bias).reshape(b, h * w, 3, heads, -1)
        q, k, v = torch.unbind(qkv, 2)
        if pool:
            q = do_pool(q.reshape(b, h, w, -1), self.q_stride)
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, heads, -1)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        scale = q.shape[-1] ** -0.5
        outs = []
        for h0 in range(0, heads, self.head_chunk):
            rows = slice(h0, h0 + self.head_chunk)
            logits = o.matmul(q[:, rows] * scale, k[:, rows].transpose(-2, -1))
            outs.append(o.matmul(torch.softmax(logits, dim=-1), v[:, rows]))
            del logits
        x = torch.cat(outs, dim=1).transpose(1, 2).reshape(b, h, w, -1)
        return o.linear(x, a.proj.weight, a.proj.bias)

    def _block(self, blk: nn.Module, spec: dict, x: torch.Tensor) -> torch.Tensor:
        """MultiScaleBlock.forward."""
        o = self.ops
        shortcut = x
        x = layer_norm(x, blk.norm1, self.enc_eps)
        if spec["dim"] != spec["dim_out"]:
            shortcut = o.linear(x, blk.proj.weight, blk.proj.bias)
            if spec["pool"]:
                shortcut = do_pool(shortcut, self.q_stride)
        window_size = spec["window"]
        if window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, window_size)
        x = self._attention(blk, spec["heads"], x, spec["pool"])
        if spec["pool"]:
            window_size = spec["window"] // self.q_stride
            h, w = shortcut.shape[1:3]
            pad_h = (window_size - h % window_size) % window_size
            pad_w = (window_size - w % window_size) % window_size
            pad_hw = (h + pad_h, w + pad_w)
        if spec["window"] > 0:
            x = window_unpartition(x, window_size, pad_hw, (h, w))
        x = shortcut + x
        m = blk.mlp
        y = layer_norm(x, blk.norm2, self.enc_eps)
        y = o.linear(gelu(o.linear(y, m.layers[0].weight, m.layers[0].bias)),
                     m.layers[1].weight, m.layers[1].bias)
        return x + y

    def _pos_embed(self, h: int, w: int) -> torch.Tensor:
        """Hiera._get_pos_embed: (1, h, w, C)."""
        trunk = self.image_encoder.trunk
        window_embed = trunk.pos_embed_window
        pos_embed = F.interpolate(trunk.pos_embed, size=(h, w), mode="bicubic")
        pos_embed = pos_embed + window_embed.tile(
            [x // y for x, y in zip(pos_embed.shape, window_embed.shape)])
        return pos_embed.permute(0, 2, 3, 1)

    def encode(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Pixels → the neck's kept levels (NCHW, finest first)."""
        o, trunk = self.ops, self.image_encoder.trunk
        mean = torch.tensor(PIXEL_MEAN, device=images.device)
        std = torch.tensor(PIXEL_STD, device=images.device)
        x = ((255.0 * images - mean) / std).permute(0, 3, 1, 2)
        x = o.conv2d(x, trunk.patch_embed.proj.weight, trunk.patch_embed.proj.bias,
                     padding=self.patch_padding, stride=self.patch_stride).permute(0, 2, 3, 1)
        x = x + self._pos_embed(*x.shape[1:3])
        xs = []
        for i, (blk, spec) in enumerate(zip(trunk.blocks, self.specs)):
            x = self._block(blk, spec, x)
            if i in self.stage_ends:
                xs.append(x.permute(0, 3, 1, 2))
        convs = self.image_encoder.neck.convs
        out, prev = [None] * len(convs), None
        n = len(convs) - 1
        for i in range(n, -1, -1):
            conv = convs[n - i].conv
            lateral = o.conv2d(xs[i], conv.weight, conv.bias)
            if i in self.fpn_top_down_levels and prev is not None:
                top_down = F.interpolate(prev.to(dtype=torch.float32), scale_factor=2.0,
                                         mode="nearest", align_corners=None, antialias=False)
                prev = lateral + top_down
            else:
                prev = lateral
            out[i] = prev
        return out[:-self.scalp] if self.scalp > 0 else out

    # -- mask decoder --------------------------------------------------------------

    def decode(self, embedding, high_res, sparse, dense, image_pe):
        """MaskDecoder.predict_masks with SAM 2's three changes; masks 1 to 3."""
        o, dec, eps = self.ops, self.sam_mask_decoder, self.dec_eps
        n, d, g, _ = embedding.shape
        t = dec.transformer
        output_tokens = torch.cat([dec.obj_score_token.weight, dec.iou_token.weight,
                                   dec.mask_tokens.weight], dim=0)
        s = 1
        tokens = torch.cat([output_tokens.expand(n, -1, -1), sparse], dim=1)
        keys = (embedding + dense).flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = tokens
        for i, layer in enumerate(t.layers):
            if i == 0:
                queries = self._attend(layer.self_attn, queries, queries, queries)
            else:
                q = queries + tokens
                queries = queries + self._attend(layer.self_attn, q, q, queries)
            queries = layer_norm(queries, layer.norm1, eps)
            queries = queries + self._attend(layer.cross_attn_token_to_image, queries + tokens,
                                             keys + key_pe, keys)
            queries = layer_norm(queries, layer.norm2, eps)
            m = layer.mlp
            queries = queries + o.linear(torch.relu(o.linear(queries, m.lin1.weight,
                                                             m.lin1.bias)),
                                         m.lin2.weight, m.lin2.bias)
            queries = layer_norm(queries, layer.norm3, eps)
            keys = keys + self._attend(layer.cross_attn_image_to_token, keys + key_pe,
                                       queries + tokens, queries)
            keys = layer_norm(keys, layer.norm4, eps)
        queries = queries + self._attend(t.final_attn_token_to_image, queries + tokens,
                                         keys + key_pe, keys)
        hs = layer_norm(queries, t.norm_final_attn, eps)
        iou_token_out = hs[:, s, :]
        mask_tokens_out = hs[:, s + 1:s + 1 + len(dec.output_hypernetworks_mlps), :]
        src = keys.transpose(1, 2).reshape(n, d, g, g)
        dc1, ln1, _, dc2 = dec.output_upscaling
        feat_s0, feat_s1 = high_res
        upscaled = gelu(layer_norm(o.conv_transpose2d(src, dc1.weight, dc1.bias) + feat_s1, ln1,
                                   1e-6, dim=1))
        upscaled = gelu(o.conv_transpose2d(upscaled, dc2.weight, dc2.bias) + feat_s0)
        hyper = torch.stack([self._mlp(mlp, mask_tokens_out[:, i])
                             for i, mlp in enumerate(dec.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = upscaled.shape
        masks = o.matmul(hyper, upscaled.view(b, c, h * w)).view(b, -1, h, w)
        iou = torch.sigmoid(self._mlp(dec.iou_prediction_head, iou_token_out))
        return masks[:, 1:], iou[:, 1:]

    def forward(self, images: torch.Tensor, clicks: torch.Tensor):
        """The image encoder frozen (no gradient), the rest trained; TF32 off."""
        o, dec = self.ops, self.sam_mask_decoder
        with fp32_context():
            with torch.no_grad():
                fpn = self.encode(images.float())
            # forward_image: the decoder's projections of the two finer levels
            feat_s0 = o.conv2d(fpn[0], dec.conv_s0.weight, dec.conv_s0.bias)
            feat_s1 = o.conv2d(fpn[1], dec.conv_s1.weight, dec.conv_s1.bias)
            # set_image: directly_add_no_mem_embed on the (HW, B, C) embedding
            embedding = fpn[-1] + self.no_mem_embed.view(1, -1, 1, 1)
            sparse, dense, image_pe = self.prompts(clicks.float())
            return self.decode(embedding, (feat_s0, feat_s1), sparse, dense, image_pe)

