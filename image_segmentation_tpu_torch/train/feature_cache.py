"""Frozen-encoder feature caching for ClipUNet training.

Counterpart of image_segmentation_tpu/train/feature_cache.py. With the
encoder frozen (the reference default) the ViT features of a training
image are the same in every epoch, so `--cache-features` computes them
once and trains the decoder alone (`ClipUNetDecoderOnly`). The features
are those the in-line frozen step would compute: the same ViT in the same
compute dtype (bf16 with K3/K4 on a card, f32 with the plain versions on
the CPU), stored as float32, which holds a bf16 value exactly; the
decoder casts them back to its compute dtype.

Not with online augmentation: the features would change every step.
Offline augmentation composes: cache the features of the expanded set.

Packing: (N, 1 + S, G, G, H) float32, NHWC, the bottleneck first, then the
skips in ascending layer order, JAX's packing. The decoder-only model
that trains on them is `ClipUNet.decoder_only()`, a view that shares the
ClipUNet's decoder modules, so no state moves between the two (JAX maps
parameter trees between its two modules, :93-102).

Features are float32 on the device or streamed. A feature set is
`MaterializedDataset` with `packed_features` set; `fit` holds it on the
device as float32 when it fits the budget (`ISTPU_TRAIN_DEVICE_CACHE_MB`,
else a quarter of the card) and streams it per step batch from host
memory otherwise. It never quantises the features to uint8, as
JAX's fit does past its budget (loop.py:801-836 through `_quantize_u8`,
which clips every value to [0, 1] and so wipes out every negative hidden
state and every one above 1). Size: ViT-B/16 features take 5 × 14 × 14 ×
768 × 4 = 3,010,560 bytes an image. At the default 80/10/10 split of the
Pet set (scripts/prepare_oxford_pet.py:69-70), about 5,880 train images
give 17.70 GB of features and 1.18 GB of int32 labels at 224 px: 18.88 GB,
inside the default budget of an 80 GB H100 (a quarter of its
`total_memory` of 85,017,493,504 bytes: 21.25 GB).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from image_segmentation_tpu_torch.data.loader import MaterializedDataset
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet


def encode_clip_features(model: ClipUNet, images: np.ndarray, batch_size: int = 32,
                         verbose: bool = False) -> np.ndarray:
    """Packed features (N, 1 + S, G, G, H) float32 of `images` (N, T, T, 3)
    through `model`'s frozen ViT, in fixed-size batches on the model's
    device (the last one padded by repeating its final image, as JAX
    does), under no_grad. An empty array gives (0, 1 + S, G, G, H)."""
    device = next(model.parameters()).device
    n, g = images.shape[0], model.vit.grid_size
    out = np.empty((n, 1 + len(model.skip_indices), g, g, model.vit.hidden_size), np.float32)
    with torch.no_grad():
        for start in range(0, n, batch_size):
            count = min(batch_size, n - start)
            idx = np.minimum(np.arange(start, start + batch_size), n - 1)
            bottleneck, skips = model.encode(torch.from_numpy(images[idx]).to(device))
            feats = torch.stack([bottleneck] + skips, dim=1)
            out[start:start + count] = feats[:count].float().cpu().numpy()
            if verbose:
                print(f"  encoded {start + count}/{n}")
    return out


def features_dataset(train_data: MaterializedDataset, feats: np.ndarray
                     ) -> MaterializedDataset:
    """The train set with its images replaced by their packed features."""
    return dataclasses.replace(train_data, images=feats, packed_features=True,
                               device_train_cache=None)
