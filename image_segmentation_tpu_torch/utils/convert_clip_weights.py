"""Offline CLIP ViT weight conversion: an HF vision checkpoint → `.npz`.

The port's counterpart of scripts/convert_clip_weights.py. It writes the
file that the JAX package's `load_pretrained_clip_params(cache_path=...)`
and this package's `models.clip_vit.load_pretrained_clip_state` both
read, so one converted file serves both:

  python -m image_segmentation_tpu_torch.utils.convert_clip_weights \
      --safetensors model.safetensors --out clip_vit_b16.npz
  python -m image_segmentation_tpu_torch.utils.convert_clip_weights \
      --torch-state-dict vision_state.pt --out clip_vit_b16.npz

then train with `run.py --clip-weights clip_vit_b16.npz`. `--safetensors`
keeps the vision tower only (`vision_model.*`) and needs neither torch's
safetensors support nor the `safetensors` package. Building a model from
a `transformers` config (the JAX script's `--from-config`) is not here:
neither of the port's machines has `transformers`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.utils."
                                     "convert_clip_weights")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--safetensors", help="an HF CLIP .safetensors checkpoint")
    src.add_argument("--torch-state-dict",
                     help="a torch.save'd HF CLIPVisionModel state dict")
    p.add_argument("--out", required=True, help="the .npz to write")
    args = p.parse_args(argv)

    from image_segmentation_tpu_torch.models.clip_vit import hf_vision_npz_arrays

    if args.safetensors:
        from image_segmentation_tpu_torch.utils.safetensors_io import read_safetensors

        state_dict = read_safetensors(args.safetensors, prefix="vision_model.")
        if not state_dict:
            sys.exit(f"{args.safetensors}: no 'vision_model.*' tensors; not an HF CLIP "
                     f"vision checkpoint?")
    else:
        import torch

        state_dict = torch.load(args.torch_state_dict, map_location="cpu", weights_only=True)
    arrays = hf_vision_npz_arrays(state_dict)
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: {len(arrays)} arrays, "
          f"{sum(a.size for a in arrays.values()) / 1e6:.1f}M params")
    return 0


if __name__ == "__main__":
    sys.exit(main())
