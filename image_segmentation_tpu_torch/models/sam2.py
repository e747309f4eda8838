"""SAM 2.1 Hiera-B+ for images: click a point, get the object's mask.

No JAX counterpart. Ravi et al., "SAM 2: Segment Anything in Images and
Videos" (2024), its image path as `sam2/sam2_image_predictor.py`
(`set_image`, `_predict`) runs the model `sam2.1_hiera_b+.yaml` builds,
with SAM 2's parameter names at the top level (`image_encoder`,
`sam_prompt_encoder`, `sam_mask_decoder`, `no_mem_embed`):

  * `image_encoder`: the Hiera-B+ trunk and FPN neck (models/hiera.py),
    whose kept levels are (N, 256, 4G, 4G), (N, 256, 2G, 2G) and the
    (N, 256, G, G) image embedding (G = 64 at 1024 px);
  * `no_mem_embed` (1, 1, 256) added to the embedding (SAM 2's
    `directly_add_no_mem_embed`: an image is a video's first frame with
    no memory);
  * `sam_prompt_encoder` and `sam_mask_decoder`: SAM's (models/sam.py),
    the decoder built with SAM 2's object-score token and head, the
    sigmoid IoU head and the high-resolution path, which reads the two
    finer levels through its `conv_s0` and `conv_s1`. The two-way
    transformer's MLPs keep SAM's names (`lin1`, `lin2`; SAM 2 calls them
    `layers.0`, `layers.1`). The video path (memory attention, memory
    encoder, object pointers) is not built: the image path never runs it.

forward(images (N, S, S, 3) float in [0, 1], clicks (N, 1, 3) float32 as
(x, y, label) in pixels) → (mask logits (N, 3, 4G, 4G) f32, IoU (N, 3) f32),
SamViTB's signature and `_predict`'s multimask output.

`dtype` is the compute dtype, parameters float32; `use_kernels` runs the
trunk's attention on K5 without tables (models/hiera.py). The image
encoder (trunk and neck) is frozen and runs under `torch.no_grad()`, as
SamViTB's does; `no_mem_embed`, the prompt encoder and the decoder,
`conv_s0` and `conv_s1` included, train. Spans: `sam.image_encoder`
(with the trunk's stage spans and `sam.neck` inside),
`sam.prompt_encoder` and `sam.mask_decoder`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from image_segmentation_tpu_torch.models.hiera import HieraConfig, ImageEncoder
from image_segmentation_tpu_torch.models.layers import lecun_normal_
from image_segmentation_tpu_torch.models.sam import (
    MaskDecoder,
    PromptEncoder,
    SamConfig,
    normalize_pixels,
)
from image_segmentation_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Sam2Config:
    """The image size, Hiera's and the neck's arguments, and the prompt
    encoder's and decoder's widths (SAM's `SamConfig`, whose encoder fields
    are not read); the defaults are SAM 2.1 Hiera-B+."""

    image_size: int = 1024
    hiera: HieraConfig = HieraConfig()
    decoder: SamConfig = SamConfig()

    @property
    def grid_size(self) -> int:
        """The image embedding's side: the neck's coarsest kept level."""
        h = self.hiera
        return self.image_size // h.level_stride(len(h.stages) - 1 - h.scalp)

    def prompt_config(self) -> SamConfig:
        """`decoder` at this image size and grid."""
        return dataclasses.replace(self.decoder, image_size=self.image_size,
                                   patch_size=self.image_size // self.grid_size)


class Sam2HieraBPlus(nn.Module):
    """forward(images (N, S, S, 3), clicks (N, 1, 3)) → (mask logits (N, 3,
    4G, 4G) f32, IoU (N, 3) f32) (module docstring)."""

    def __init__(self, sam2: Sam2Config = Sam2Config(), dtype: torch.dtype = torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        self.cfg = sam2
        self.dtype = dtype
        prompt = sam2.prompt_config()
        d = prompt.prompt_embed_dim
        if sam2.hiera.d_model != d or len(sam2.hiera.stages) - sam2.hiera.scalp != 3:
            raise ValueError("the neck must keep three levels at the decoder's width")
        self.image_encoder = ImageEncoder(sam2.hiera, use_kernels)
        self.sam_prompt_encoder = PromptEncoder(prompt)
        self.sam_mask_decoder = MaskDecoder(prompt, pred_obj_scores=True, iou_sigmoid=True,
                                            high_res=True)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d))

    def forward(self, images: torch.Tensor, clicks: torch.Tensor):
        s = self.cfg.image_size
        if images.shape[1:] != (s, s, 3):
            raise ValueError(f"Sam2HieraBPlus expects (N, {s}, {s}, 3) images, "
                             f"got {tuple(images.shape)}")
        with profiling.span("sam.image_encoder"):
            with torch.no_grad():
                fine, mid, embedding = self.image_encoder(
                    normalize_pixels(images).to(self.dtype))
        with profiling.span("sam.prompt_encoder"):
            sparse, dense = self.sam_prompt_encoder(clicks)
            image_pe = self.sam_prompt_encoder.image_pe(images.device)
        with profiling.span("sam.mask_decoder"):
            embedding = embedding + self.no_mem_embed.to(self.dtype).view(1, -1, 1, 1)
            masks, iou = self.sam_mask_decoder(embedding, image_pe, sparse, dense,
                                               high_res_features=(fine, mid))
        return masks[:, 1:].float(), iou[:, 1:].float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Sam2HieraBPlus":
        """Random init from `generator`: LeCun-normal kernels (a transpose
        conv's fan-in is its input channels), zero biases, unit norms,
        N(0, 0.02) position embeddings and `no_mem_embed` (SAM 2 zeroes the
        embeddings before loading its checkpoint; random ones exercise the
        sums), N(0, 1) token embeddings and Fourier matrix (SAM's)."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("pos_embed", "pos_embed_window", "no_mem_embed"):
                p.normal_(0.0, 0.02, generator=generator)
            elif name.endswith("embed.weight") or ".point_embeddings." in name or (
                    name.endswith(("_token.weight", "mask_tokens.weight"))):
                p.normal_(0.0, 1.0, generator=generator)
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:  # LayerNorm weights
                p.fill_(1.0)
            else:
                fan_in = p.shape[0] if ".output_upscaling." in name else p[0].numel()
                lecun_normal_(p, fan_in, generator)
        self.sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(
            0.0, 1.0, generator=generator)
        return self
