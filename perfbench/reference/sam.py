"""The benchmark's plain reference of Segment Anything ViT-B (Kirillov et al. 2023,
`segment_anything/build_sam.py` `build_sam_vit_b`): the forward, the
fine-tuning loss and, through autograd, the gradients, in float32 plain
PyTorch. It imports neither the JAX package nor its port, and no kernel;
`ops.fp32_context` turns TF32 off for its products and convolutions.

It is `tests/sam_reference.py` with the products and convolutions going
through `perfbench/reference/ops.py` `Ops`, so that the float8 control
(`ops.control_ops()`) can round them; `tests/test_torch_sam.py` holds the
two copies to each other on the same seeded weights. The LayerNorm
epsilons are SAM's own (1e-6 in the encoder and LayerNorm2d, 1e-5 in the
decoder's transformer), given as widths are, not `Ops.configure`'s.

Parameters are held by torch.nn modules under SAM's names, which are the
port's (models/sam.py), so one state dict loads into both; every
computation is written out here:
  * image encoder: pixels (255·x − mean) / std; a patch conv; + the
    absolute position embedding; blocks x + Attn(LN1(x)) (in windows of
    the zero-padded map but at the global blocks), x + MLP(LN2(x)) with
    the exact GELU; Attn = softmax((q·d^-½)·kᵀ + rel_h + rel_w)·v with
    rel_h[(i, j), kh] = q(i, j)·Rh[i − kh + h − 1] (unscaled q; rel_w
    likewise), computed at global blocks in blocks of `head_chunk` heads
    so that a 1024 px image fits; the neck (conv 1×1, LayerNorm2d, conv
    3×3, LayerNorm2d);
  * prompt encoder: [sin, cos](2π·(2u − 1)·G) of the click at its pixel
    centre and SAM's padding point (label −1, zero encoding, plus the
    not-a-point embedding), + the label's point embedding; the no-mask
    dense embedding; the grid's encoding at pixel centres;
  * mask decoder: the two-way transformer (the first layer's
    self-attention without positional encoding or residual), the final
    token-to-image attention, ×4 transpose-conv upscaling with
    LayerNorm2d and GELU, hypernetwork MLPs, the IoU head; masks 1 to 3.
  * loss: per image the lowest of its three masks' 20·focal (α 0.25,
    γ 2) + Dice, plus the mean squared error of the IoU predictions
    against each mask's detached IoU (logits > 0) with the not-background
    target at the masks' resolution.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.ops import Ops, fp32_context

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def layer_norm(x: torch.Tensor, ln: nn.Module, eps: float, dim: int = -1) -> torch.Tensor:
    """Mean and biased variance over `dim`; the affine along it."""
    mean = x.mean(dim, keepdim=True)
    var = ((x - mean) ** 2).mean(dim, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    shape = [1] * x.dim()
    shape[dim] = -1
    return y * ln.weight.view(shape) + ln.bias.view(shape)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


class Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


def _lin(a: int, b: int, bias: bool = True) -> nn.Linear:
    return nn.Linear(a, b, bias=bias)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int, size: int, window: int):
        super().__init__()
        self.window = window
        self.norm1 = Norm(dim)
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = _lin(dim, 3 * dim), _lin(dim, dim)
        self.attn.rel_pos_h = nn.Parameter(torch.empty(2 * size - 1, dim // heads))
        self.attn.rel_pos_w = nn.Parameter(torch.empty(2 * size - 1, dim // heads))
        self.norm2 = Norm(dim)
        self.mlp = nn.Module()
        self.mlp.lin1, self.mlp.lin2 = _lin(dim, mlp), _lin(mlp, dim)


def _rel_table(table: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, d): table[i − k + size − 1]."""
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + size - 1]


class Sam(nn.Module):
    """forward(images (N, S, S, 3) in [0, 1], clicks (N, 1, 3)) → (masks
    (N, 3, 4G, 4G), IoU (N, 3)); the widths as `build_sam_vit_b` names them."""

    def __init__(self, image_size=1024, patch_size=16, embed_dim=768, depth=12, num_heads=12,
                 mlp_dim=3072, window_size=14, global_attn_indexes=(2, 5, 8, 11),
                 prompt_embed_dim=256, decoder_depth=2, decoder_num_heads=8,
                 decoder_mlp_dim=2048, attention_downsample_rate=2, num_multimask_outputs=3,
                 iou_head_depth=3, iou_head_hidden_dim=256, encoder_eps=1e-6,
                 decoder_eps=1e-5, ops=None, head_chunk: int = 4):
        super().__init__()
        self.ops = ops or Ops()
        self.image_size, self.patch, self.heads = image_size, patch_size, num_heads
        self.g = image_size // patch_size
        self.enc_eps, self.dec_eps, self.dec_heads = encoder_eps, decoder_eps, decoder_num_heads
        self.head_chunk = head_chunk
        d, c = prompt_embed_dim, embed_dim
        enc = self.image_encoder = nn.Module()
        enc.patch_embed = nn.Module()
        enc.patch_embed.proj = nn.Conv2d(3, c, patch_size, stride=patch_size)
        enc.pos_embed = nn.Parameter(torch.empty(1, self.g, self.g, c))
        enc.blocks = nn.ModuleList(
            EncoderBlock(c, num_heads, mlp_dim,
                         self.g if i in global_attn_indexes else window_size,
                         0 if i in global_attn_indexes else window_size)
            for i in range(depth))
        enc.neck = nn.Sequential(nn.Conv2d(c, d, 1, bias=False), Norm(d),
                                 nn.Conv2d(d, d, 3, padding=1, bias=False), Norm(d))
        pe = self.prompt_encoder = nn.Module()
        pe.pe_layer = nn.Module()
        pe.pe_layer.register_buffer("positional_encoding_gaussian_matrix",
                                    torch.empty(2, d // 2))
        pe.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        pe.not_a_point_embed, pe.no_mask_embed = nn.Embedding(1, d), nn.Embedding(1, d)
        dec = self.mask_decoder = nn.Module()
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
        dec.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), Norm(d // 4), nn.Identity(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2))

        def mlp(dims):
            m = nn.Module()
            m.layers = nn.ModuleList(_lin(a, b) for a, b in zip(dims[:-1], dims[1:]))
            return m

        dec.output_hypernetworks_mlps = nn.ModuleList(mlp((d, d, d, d // 8)) for _ in range(k))
        dec.iou_prediction_head = mlp((d,) + (iou_head_hidden_dim,) * (iou_head_depth - 1)
                                      + (k,))

    # -- image encoder ---------------------------------------------------------

    def _attention(self, blk: EncoderBlock, x: torch.Tensor) -> torch.Tensor:
        o, a = self.ops, blk.attn
        b, h, w, c = x.shape
        nh, hd, s = self.heads, c // self.heads, h * w
        qkv = o.linear(x.reshape(b, s, c), a.qkv.weight, a.qkv.bias)
        qkv = qkv.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)  # (3, B, heads, S, d)
        r_h = _rel_table(a.rel_pos_h, h).transpose(1, 2)  # (h, d, kh)
        r_w = _rel_table(a.rel_pos_w, w).transpose(1, 2)  # (w, d, kw)
        outs = []
        for h0 in range(0, nh, self.head_chunk):
            q, k, v = (t[:, h0:h0 + self.head_chunk] for t in qkv)
            q5 = q.reshape(q.shape[0], q.shape[1], h, w, hd)
            rel_h = o.matmul(q5, r_h)  # (B, c, h, w, kh)
            rel_w = o.matmul(q5.transpose(2, 3), r_w).transpose(2, 3)  # (B, c, h, w, kw)
            logits = o.matmul(q * hd ** -0.5, k.transpose(-2, -1))
            logits = (logits.view(*q.shape[:2], h, w, h, w) + rel_h[..., :, None]
                      + rel_w[..., None, :]).view(*q.shape[:2], s, s)
            outs.append(o.matmul(torch.softmax(logits, dim=-1), v))
            del logits
        out = torch.cat(outs, dim=1).transpose(1, 2).reshape(b, h, w, c)
        return o.linear(out, a.proj.weight, a.proj.bias)

    def _block(self, blk: EncoderBlock, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = layer_norm(x, blk.norm1, self.enc_eps)
        ws = blk.window
        if ws:
            ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            y = y.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            y = self._attention(blk, y.reshape(-1, ws, ws, c))
            y = y.view(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(b, hp, wp, c)[:, :h, :w]
        else:
            y = self._attention(blk, y)
        x = x + y
        o, m = self.ops, blk.mlp
        y = layer_norm(x, blk.norm2, self.enc_eps)
        y = o.linear(gelu(o.linear(y, m.lin1.weight, m.lin1.bias)), m.lin2.weight, m.lin2.bias)
        return x + y

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        o, enc = self.ops, self.image_encoder
        mean = torch.tensor(PIXEL_MEAN, device=images.device)
        std = torch.tensor(PIXEL_STD, device=images.device)
        x = ((255.0 * images - mean) / std).permute(0, 3, 1, 2)
        x = o.conv2d(x, enc.patch_embed.proj.weight, enc.patch_embed.proj.bias,
                     stride=self.patch).permute(0, 2, 3, 1)
        x = x + enc.pos_embed
        for blk in enc.blocks:
            x = self._block(blk, x)
        conv1, ln1, conv2, ln2 = enc.neck
        y = o.conv2d(x.permute(0, 3, 1, 2), conv1.weight)
        y = layer_norm(y, ln1, self.enc_eps, dim=1)
        y = o.conv2d(y, conv2.weight, padding=1)
        return layer_norm(y, ln2, self.enc_eps, dim=1)

    # -- prompt encoder ----------------------------------------------------------

    def _pe(self, coords: torch.Tensor) -> torch.Tensor:
        g = self.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
        c = 2 * math.pi * ((2 * coords - 1) @ g)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def prompts(self, clicks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(sparse (N, 2, D), dense (N, D, G, G), image pe (1, D, G, G))."""
        pe = self.prompt_encoder
        n, g = clicks.shape[0], self.g
        pts = torch.cat([clicks[..., :2] + 0.5, clicks.new_zeros(n, 1, 2)], dim=1)
        labels = torch.cat([clicks[..., 2], clicks.new_full((n, 1), -1.0)], dim=1)
        sparse = self._pe(pts / self.image_size)
        pad = labels == -1
        sparse = torch.where(pad[..., None], torch.zeros_like(sparse), sparse)
        sparse = sparse + pad[..., None] * pe.not_a_point_embed.weight
        sparse = sparse + (labels == 0)[..., None] * pe.point_embeddings[0].weight
        sparse = sparse + (labels == 1)[..., None] * pe.point_embeddings[1].weight
        dense = pe.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(n, -1, g, g)
        centres = (torch.arange(g, device=clicks.device, dtype=torch.float32) + 0.5) / g
        yy, xx = torch.meshgrid(centres, centres, indexing="ij")
        image_pe = self._pe(torch.stack([xx, yy], dim=-1)).permute(2, 0, 1)[None]
        return sparse, dense, image_pe

    # -- mask decoder --------------------------------------------------------------

    def _attend(self, a: nn.Module, q, k, v) -> torch.Tensor:
        o, nh = self.ops, self.dec_heads
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], nh, -1).transpose(1, 2)  # noqa: E731
        q = heads(o.linear(q, a.q_proj.weight, a.q_proj.bias))
        k = heads(o.linear(k, a.k_proj.weight, a.k_proj.bias))
        v = heads(o.linear(v, a.v_proj.weight, a.v_proj.bias))
        p = torch.softmax(o.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1]), dim=-1)
        out = o.matmul(p, v).transpose(1, 2).reshape(q.shape[0], -1, nh * q.shape[-1])
        return o.linear(out, a.out_proj.weight, a.out_proj.bias)

    def _mlp(self, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(m.layers):
            x = self.ops.linear(x, lin.weight, lin.bias)
            if i < len(m.layers) - 1:
                x = torch.relu(x)
        return x

    def decode(self, embedding, sparse, dense, image_pe):
        o, dec, eps = self.ops, self.mask_decoder, self.dec_eps
        n, d, g, _ = embedding.shape
        t = dec.transformer
        tokens = torch.cat([dec.iou_token.weight, dec.mask_tokens.weight], dim=0)
        tokens = torch.cat([tokens.expand(n, -1, -1), sparse], dim=1)
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
        src = keys.transpose(1, 2).reshape(n, d, g, g)
        up1, ln, _, up2 = dec.output_upscaling
        y = gelu(layer_norm(o.conv_transpose2d(src, up1.weight, up1.bias), ln, 1e-6, dim=1))
        y = gelu(o.conv_transpose2d(y, up2.weight, up2.bias))
        hyper = torch.stack([self._mlp(mlp, hs[:, 1 + i])
                             for i, mlp in enumerate(dec.output_hypernetworks_mlps)], dim=1)
        masks = o.matmul(hyper, y.flatten(2)).view(n, -1, y.shape[2], y.shape[3])
        iou = self._mlp(dec.iou_prediction_head, hs[:, 0])
        return masks[:, 1:], iou[:, 1:]

    def forward(self, images: torch.Tensor, clicks: torch.Tensor):
        """The image encoder frozen (no gradient), the rest trained; TF32 off."""
        with fp32_context():
            with torch.no_grad():
                embedding = self.encode(images.float())
            sparse, dense, image_pe = self.prompts(clicks.float())
            return self.decode(embedding, sparse, dense, image_pe)


def mask_losses(masks: torch.Tensor, iou_pred: torch.Tensor, labels: torch.Tensor,
                focal_weight: float = 20.0, alpha: float = 0.25, gamma: float = 2.0):
    """(each mask's 20·focal + Dice (N, K), the IoU predictions' mean squared
    error) for masks (N, K, m, m), iou_pred (N, K), labels (N, S, S) class
    ids (0 background)."""
    side = masks.shape[-1]
    stride = labels.shape[-1] // side
    t = (labels[:, ::stride, ::stride][:, :side, :side] != 0).float()[:, None].expand_as(masks)
    p = torch.sigmoid(masks)
    ce = F.binary_cross_entropy_with_logits(masks, t, reduction="none")
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    focal = (alpha_t * (1 - p_t) ** gamma * ce).mean(dim=(2, 3))
    dice = 1 - (2 * (p * t).sum(dim=(2, 3)) + 1) / (p.sum(dim=(2, 3)) + t.sum(dim=(2, 3)) + 1)
    with torch.no_grad():
        pred = masks > 0
        inter = (pred & (t > 0)).sum(dim=(2, 3)).float()
        union = (pred | (t > 0)).sum(dim=(2, 3)).float()
        iou = inter / union.clamp(min=1.0)
    return focal_weight * focal + dice, ((iou_pred - iou) ** 2).mean()


def sam_loss(masks: torch.Tensor, iou_pred: torch.Tensor, labels: torch.Tensor,
             focal_weight: float = 20.0, alpha: float = 0.25, gamma: float = 2.0):
    """(loss, each image's lowest-loss mask) for masks (N, K, m, m), iou_pred
    (N, K), labels (N, S, S) class ids (0 background)."""
    per_mask, iou_term = mask_losses(masks, iou_pred, labels, focal_weight, alpha, gamma)
    choice = per_mask.detach().argmin(dim=1)
    return per_mask.gather(1, choice[:, None]).mean() + iou_term, choice


def trainable(model: nn.Module, frozen: Sequence[str] = ("image_encoder",)):
    """The named parameters not under a frozen prefix; the frozen ones stop
    their gradient."""
    out = {}
    for n, p in model.named_parameters():
        if any(n == f or n.startswith(f + ".") for f in frozen):
            p.requires_grad_(False)
        else:
            out[n] = p
    return out
